"""The port's data pipeline against the JAX package's, on the CPU.

From one FASTA (Uniref50-style headers, made with numpy from a seed) and
one ETL seed, both packages' ``generate_data`` write the same shards, the
same bytes (gzip's header time pinned, as it would otherwise differ by
the second); both iterators yield equal batches for every mode (skip,
loop across passes, process shards, shuffle_seed); and the native codec
and the Python codec read and write the same records. All equalities are
exact.
"""

import gzip
import types
from pathlib import Path

import numpy as np
import pytest

from progen_tpu.data import dataset as jdataset
from progen_tpu.data import fasta as jfasta
from progen_tpu_torch.data import _native, dataset, fasta, tfrecord

AAS = "ACDEFGHIKLMNPQRSTVWY"
TAXA = ["Homo sapiens", "Escherichia coli", "Saccharomyces cerevisiae",
        "Mus musculus"]


def write_fasta(path: Path, n: int, seed: int, lo: int = 8,
                hi: int = 60) -> Path:
    """n records with Uniref50-style headers; every seventh has no Tax=."""
    rng = np.random.default_rng(seed)
    with path.open("w") as f:
        for i in range(n):
            seq = "".join(rng.choice(list(AAS), rng.integers(lo, hi + 1)))
            tax = ("" if i % 7 == 3 else
                   f" Tax={TAXA[rng.integers(len(TAXA))]} TaxID=9606")
            f.write(f">UniRef50_P{i:05d} Protein {i} n=2{tax} "
                    f"RepID=P{i:05d}_HUMAN\n")
            for k in range(0, len(seq), 60):  # FASTA line wrapping
                f.write(seq[k:k + 60] + "\n")
    return path


def etl_config(fasta_path: Path, out: Path, **over) -> dict:
    cfg = dict(read_from=str(fasta_path), write_to=str(out), num_samples=90,
               max_seq_len=50, prob_invert_seq_annotation=0.5,
               fraction_valid_data=0.2, num_sequences_per_file=40,
               sort_annotations=False)
    return {**cfg, **over}


@pytest.fixture
def pinned_gzip_time(monkeypatch):
    """gzip writes the time into each file's header: pin it, so two
    writes of the same records are the same bytes."""
    monkeypatch.setattr(gzip, "time",
                        types.SimpleNamespace(time=lambda: 1_700_000_000))


@pytest.mark.parametrize("seed,sort", [(7, False), (11, True)])
def test_etl_shards_byte_equal_to_jax(tmp_path, pinned_gzip_time, seed,
                                      sort):
    src = write_fasta(tmp_path / "u50.fasta", 120, seed=seed)
    want = jfasta.generate_data(
        etl_config(src, tmp_path / "jax", sort_annotations=sort), seed=seed)
    got = fasta.generate_data(
        etl_config(src, tmp_path / "port", sort_annotations=sort), seed=seed)
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert len(got) > 2  # several train shards and a valid one
    for g, w in zip(got, want):
        assert Path(g).read_bytes() == Path(w).read_bytes(), g


def test_parse_and_strings_match_jax(tmp_path):
    src = write_fasta(tmp_path / "u50.fasta", 30, seed=3)
    assert list(fasta.parse_fasta(src)) == list(jfasta.parse_fasta(src))
    import random

    r1, r2 = random.Random(5), random.Random(5)
    for desc, seq in fasta.parse_fasta(src):
        kw = dict(prob_invert_seq_annotation=0.5, sort_annotations=False)
        assert fasta.sequence_strings(desc, seq, rng=r1, **kw) == \
            jfasta.sequence_strings(desc, seq, rng=r2, **kw)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Shards written by the port's ETL: 3 train files, 1 valid."""
    root = tmp_path_factory.mktemp("shards")
    src = write_fasta(root / "u50.fasta", 60, seed=1)
    fasta.generate_data(etl_config(src, root / "data", num_samples=60,
                                   num_sequences_per_file=30), seed=2)
    return root / "data"


# (seq_len, batch, iter_fn keywords, batches to take: None = all)
MODES = {
    "one_pass": (24, 4, {}, None),
    "skip": (24, 4, dict(skip=9), None),
    "ragged_tail": (16, 7, dict(skip=3), None),
    "loop_across_passes": (24, 8, dict(loop=True), 30),
    "skip_past_an_epoch": (24, 4, dict(skip=130, loop=True), 40),
    "process_1_of_2": (24, 4, dict(skip=5, loop=True, process_index=1,
                                   process_count=2), 25),
    "shuffle": (24, 4, dict(loop=True, shuffle_seed=3), 40),
    "shuffle_skip": (20, 4, dict(skip=57, loop=True, shuffle_seed=0), 40),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_iterator_batches_equal_jax(shards, mode):
    seq_len, batch, kw, take = MODES[mode]
    n, port_fn = dataset.iterator_from_tfrecords_folder(str(shards))
    n_j, jax_fn = jdataset.iterator_from_tfrecords_folder(str(shards))
    assert n == n_j > 0
    got_it, want_it = port_fn(seq_len, batch, **kw), jax_fn(seq_len, batch,
                                                           **kw)
    try:
        got = [b for _, b in zip(range(take or 10**6), got_it)]
        want = [b for _, b in zip(range(take or 10**6), want_it)]
    finally:
        got_it.close()
        want_it.close()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_valid_split_and_counts(shards):
    n, fn = dataset.iterator_from_tfrecords_folder(str(shards), "valid")
    n_j, _ = jdataset.iterator_from_tfrecords_folder(str(shards), "valid")
    assert n == n_j > 0
    assert sum(b.shape[0] for b in fn(24, 5)) == n


def test_native_and_python_codecs_agree(shards, tmp_path, monkeypatch):
    if _native.load() is None:
        pytest.skip("no g++: the native engine did not build")
    path = sorted(shards.glob("*.train.tfrecord.gz"))[0]
    native = list(tfrecord.read_tfrecords(str(path)))
    records = [b"", b"# M", b"[tax=Homo sapiens] # " + b"MKV" * 200]
    native_file, python_file = tmp_path / "n.gz", tmp_path / "p.gz"
    with tfrecord.tfrecord_writer(str(native_file)) as write:
        for r in records:
            write(r)
    native_collate = dataset.collate(native[:5], 16)

    monkeypatch.setattr(_native, "load", lambda: None)
    assert list(tfrecord.read_tfrecords(str(path))) == native
    with tfrecord.tfrecord_writer(str(python_file)) as write:
        for r in records:
            write(r)
    assert gzip.decompress(python_file.read_bytes()) == \
        gzip.decompress(native_file.read_bytes())
    assert list(tfrecord.read_tfrecords(str(native_file))) == records
    np.testing.assert_array_equal(dataset.collate(native[:5], 16),
                                  native_collate)


def test_native_library_builds_under_build_dir():
    lib = _native.load()
    if lib is None:
        pytest.skip("no g++: the native engine did not build")
    repo = Path(__file__).resolve().parents[1]
    assert Path(lib._name).parent == repo / "build" / "native"


def test_corrupt_record_raises(tmp_path):
    path = tmp_path / "0.2.train.tfrecord.gz"
    with tfrecord.tfrecord_writer(str(path)) as write:
        write(b"# MKVL")
        write(b"# MSTA")
    raw = bytearray(gzip.decompress(path.read_bytes()))
    raw[20] ^= 0x01  # inside the first payload
    path.write_bytes(gzip.compress(bytes(raw)))
    with pytest.raises(ValueError, match="corrupt"):
        list(tfrecord.read_tfrecords(str(path)))


@pytest.mark.parametrize("call", ["iterator", "etl"])
def test_gcs_paths_are_refused(tmp_path, call):
    with pytest.raises(ValueError, match="not ported"):
        if call == "iterator":
            dataset.iterator_from_tfrecords_folder("gs://bucket/data")
        else:
            fasta.write_tfrecord_shards([b"# M"], "gs://bucket/out",
                                        fraction_valid_data=0.5,
                                        num_sequences_per_file=1)

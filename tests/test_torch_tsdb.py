"""The port's ``telemetry/tsdb.py`` against the JAX package's: the same
seeded sample stream, appended to a ring of each package under the same
byte budget, leaves the same blocks (rotation, downsampling, drops) and
replays the same records; each package's reader reads the other's store
and archive alike, and the shipped archive verifies under both."""

import filecmp
import json

import pytest

from progen_tpu.telemetry import collector as jax_collector
from progen_tpu.telemetry import tsdb as jax_tsdb
from progen_tpu_torch.telemetry import collector as pt_collector
from progen_tpu_torch.telemetry import tsdb as pt_tsdb
from torch_telemetry_cases import fleet_samples

PACKAGES = {"port": pt_tsdb, "jax": jax_tsdb}


def _fill(mod, root, samples, archive=None, **kw):
    shipper = mod.BlockShipper(archive, log=False) if archive else None
    db = mod.RingTSDB(root, shipper=shipper, **kw)
    for rec in samples:
        db.append(rec)
    blocks = db.blocks()
    db.close()
    return blocks


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (cmp.left_only,
                                                      cmp.right_only)
    for name in cmp.common_files:
        if name == "archive.json":
            continue  # holds the archive's own path
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("budget,block", [
    (8 << 20, 256 << 10), (6000, 1500), (3000, 700), (1500, 400)])
def test_ring_blocks_and_replay_match(tmp_path, budget, block):
    samples = fleet_samples(pt_collector.make_sample, 3, ticks=30)
    assert samples == fleet_samples(jax_collector.make_sample, 3, ticks=30)
    got = _fill(pt_tsdb, tmp_path / "pt", samples, budget_bytes=budget,
                block_bytes=block)
    want = _fill(jax_tsdb, tmp_path / "jax", samples, budget_bytes=budget,
                 block_bytes=block)
    assert got == want
    _same_tree(tmp_path / "pt", tmp_path / "jax")
    for reader in (pt_tsdb.TsdbReader, jax_tsdb.TsdbReader):
        a, b = reader(tmp_path / "pt"), reader(tmp_path / "jax")
        assert list(a.read()) == list(b.read())
        assert a.blocks() == b.blocks()


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_archive_union_reads_alike(tmp_path, writer):
    samples = fleet_samples(pt_collector.make_sample, 4, ticks=40)
    _fill(PACKAGES[writer], tmp_path / "ring", samples,
          archive=tmp_path / "archive", budget_bytes=3000,
          block_bytes=600)
    assert pt_tsdb.verify_archive(tmp_path / "archive") == \
        jax_tsdb.verify_archive(tmp_path / "archive")
    assert all(pt_tsdb.verify_archive(tmp_path / "archive").values())
    pd, jd = pt_tsdb.LineDrops(), jax_tsdb.LineDrops()
    a = pt_tsdb.TsdbReader(tmp_path / "ring")
    b = jax_tsdb.TsdbReader(tmp_path / "ring")
    assert a.archive == b.archive is not None
    recs = list(a.read(pd))
    assert recs == list(b.read(jd))
    assert len(recs) > sum(
        1 for p in (tmp_path / "ring").glob("block-*.jsonl")
        for _ in p.open())
    assert pd.count == jd.count == 0
    assert a.blocks() == b.blocks()
    assert any(blk["archived"] for blk in a.blocks())


def test_reopened_ring_drops_a_torn_tail_alike(tmp_path):
    samples = fleet_samples(pt_collector.make_sample, 5, ticks=6)
    for name, mod in PACKAGES.items():
        _fill(mod, tmp_path / name, samples)
        (active,) = sorted((tmp_path / name).glob("block-*.jsonl"))
        with active.open("a") as f:
            f.write('{"ev": "sample", "ts": 99')
        db = mod.RingTSDB(tmp_path / name)
        assert db.dropped_lines == 1
        db.append(samples[0])
        db.close()
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_merge_pair_matches():
    a, b = fleet_samples(pt_collector.make_sample, 6, ticks=2)[:2]
    b = dict(a, ts=a["ts"] + 1.0, counters={"requests_completed": 9.0})
    assert pt_tsdb.merge_pair(a, b) == jax_tsdb.merge_pair(a, b)
    assert json.dumps(pt_tsdb.merge_pair(a, b), sort_keys=True)

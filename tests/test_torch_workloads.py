"""The port's protein-design workloads (``progen_tpu_torch/workloads/``),
its fault injector and its reference-checkpoint converter, on the CPU,
against the JAX package.

Config: the JAX workload tests' byte-vocab model (vocab 256, dim 32,
seq_len 32, depth 2, window 8, one gMLP layer, heads 2, dim_head 16,
ff_mult 2, float32), and a pure-attention twin (no gMLP layer, seq_len
64) whose scorer buckets lengths. Every weight is drawn from numpy with a
seed into the JAX tree's shapes and goes to the port through
``convert.py``.

Tolerances: NLLs and logprobs against the JAX package 1e-4 absolute and
relative (two layers of float32 sums in different orders); the batched
scan against the port's batch-1 loop reference 1e-5 absolute (the same
arithmetic, the CPU's products taking another path for one row than for
several). Ids, seq_index, n_tokens, shard files and journal ops are
compared exactly, and the scorer against the port's own ``score_step`` at
the same batch bit for bit.
"""

import json
import pickle
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu import convert as jconvert
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.resilience import chaos as jchaos
from progen_tpu.workloads import mutagenesis as jmut
from progen_tpu.workloads import scoring as jscoring
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch import convert as tconvert
from progen_tpu_torch.checkpoint import get_checkpoint_fns
from progen_tpu_torch.data.dataset import collate
from progen_tpu_torch.data.tfrecord import tfrecord_writer
from progen_tpu_torch.resilience import chaos
from progen_tpu_torch.telemetry import spans
from progen_tpu_torch.workloads import (
    AA_ALPHABET,
    SCORE_OPS,
    fasta_records,
    mutagenesis_scan,
    reference_point_mutant_nll,
    run_batch_score,
    score_step,
    scored_ids,
    tfrecord_records,
)
from progen_tpu_torch.workloads import scoring as tscoring
from progen_tpu_torch.workloads.mutagenesis import mutant_rows

BYTE = dict(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
PURE = dict(BYTE, seq_len=64, global_mlp_depth=0)
TOL = dict(atol=1e-4, rtol=1e-4)


def numpy_params(cfg: jcfg.ProGenConfig, seed: int = 0) -> dict:
    """A flax params tree of the JAX model's shapes, every leaf drawn from
    numpy: kernels N(0, 1/fan_in), biases N(0, 0.1), the embedding N(0,
    1), norm scales U(0.5, 1.5), the SGU's weights N(0, 1/n) and biases
    N(0, 1)."""
    shapes = jax.eval_shape(
        JProGen(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, cfg.seq_len), jnp.int32))["params"]
    shapes = jax.tree.map(lambda x: getattr(x, "value", x), shapes,
                          is_leaf=lambda x: hasattr(x, "value"))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name == "bias":
            a = rng.standard_normal(shape) * 0.1
        elif name == "embedding":
            a = rng.standard_normal(shape)
        elif name == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "spatial_weights":
            a = rng.standard_normal(shape) / np.sqrt(cfg.seq_len)
        elif name == "spatial_biases":
            a = rng.standard_normal(shape)
        else:
            raise AssertionError(f"no draw for {name}")
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def make_pair(kw: dict, seed: int = 0):
    """(JAX model, its params, the port's model on the same weights)."""
    jm = JProGen(jcfg.ProGenConfig(**kw))
    tree = numpy_params(jm.config, seed)
    cfg = ProGenConfig(**kw)
    pm = ProGen(cfg, device="cpu", seed=None)
    pm.load_state_dict(tconvert.flax_params_to_state_dict(tree, cfg))
    return jm, tree, pm.eval()


@pytest.fixture(scope="module")
def byte_pair():
    return make_pair(BYTE)


@pytest.fixture(scope="module")
def pure_pair():
    return make_pair(PURE, seed=1)


def _aa(rng, n: int) -> str:
    return "".join(rng.choice(np.array(list(AA_ALPHABET)), size=n))


def _records(n: int, lo: int, hi: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(f"r{i}", ("# " + _aa(rng, int(rng.integers(lo, hi))))
             .encode("utf-8")) for i in range(n)]


def _shards(out_dir) -> dict:
    """shard file name -> its records, in order."""
    return {p.name: [json.loads(ln) for ln in p.read_text().splitlines()]
            for p in sorted(Path(out_dir).glob("scores-*.jsonl"))}


def _ids(out_dir) -> list:
    return [r["id"] for recs in _shards(out_dir).values() for r in recs]


def _journal(out_dir) -> list:
    return [json.loads(ln) for ln in
            (Path(out_dir) / "score_journal.jsonl").read_text().splitlines()]


def _assert_same_scores(got_dir, want_dir):
    got, want = _shards(got_dir), _shards(want_dir)
    assert list(got) == list(want)
    for name in want:
        assert len(got[name]) == len(want[name])
        for g, w in zip(got[name], want[name]):
            assert set(g) == set(w)
            for k in ("id", "seq_index", "n_tokens"):
                assert g[k] == w[k], (name, k)
            np.testing.assert_allclose(g["nll"], w["nll"], **TOL)
            np.testing.assert_allclose(g["ppl"], w["ppl"], **TOL)
            if "logprobs" in w:
                np.testing.assert_allclose(g["logprobs"], w["logprobs"],
                                           **TOL)


class TestScoringAgainstJax:
    @pytest.mark.parametrize("pair,lengths", [
        ("byte_pair", (8, 26)), ("pure_pair", (4, 60))],
        ids=["gmlp_fixed_bucket", "pure_attention_buckets"])
    def test_batch_score_matches_jax(self, request, tmp_path, pair,
                                     lengths):
        jm, tree, pm = request.getfixturevalue(pair)
        recs = _records(13, *lengths, seed=5) + [
            ("long1", b"X" * (pm.config.seq_len + 3))]
        want = jscoring.run_batch_score(jm, tree, list(recs),
                                        str(tmp_path / "jax"),
                                        batch_size=4, shard_size=5)
        got = run_batch_score(pm, list(recs), str(tmp_path / "port"),
                              batch_size=4, shard_size=5)
        for k in ("n_scored", "n_skipped", "n_resumed", "tokens",
                  "batches", "stopped_early"):
            assert got[k] == want[k], k
        assert set(got) == set(want) and set(got["times"]) == \
            set(want["times"])
        _assert_same_scores(tmp_path / "port", tmp_path / "jax")
        strip = [{k: v for k, v in r.items()
                  if k not in ("step_s", "elapsed_s", "goodput_pct",
                               "times", "out_dir", "pid")}
                 for r in _journal(tmp_path / "port")]
        want_j = [{k: v for k, v in r.items()
                   if k not in ("step_s", "elapsed_s", "goodput_pct",
                                "times", "out_dir", "pid")}
                  for r in _journal(tmp_path / "jax")]
        assert strip == want_j

    def test_pure_attention_scores_in_several_buckets(self, tmp_path,
                                                      pure_pair):
        _, _, pm = pure_pair
        recs = _records(8, 4, 60, seed=6)
        run_batch_score(pm, recs, str(tmp_path), batch_size=2)
        buckets = {r["bucket"] for r in _journal(tmp_path)
                   if r["op"] == "batch"}
        assert buckets == {32, 64}  # the floor is max(32, window)

    def test_record_readers_match_jax(self, tmp_path):
        fasta = tmp_path / "c.fasta"
        fasta.write_text(">a1 first protein\nMKTAY\nIAK\n>\nGIVEQ\n"
                         ">c3 Tax=Homo\nmkv\n")
        for ctx in ("", "[tax=Homo]"):
            assert list(fasta_records(str(fasta), ctx)) == \
                list(jscoring.fasta_records(str(fasta), ctx))
        for i, n in ((0, 3), (1, 2)):
            with tfrecord_writer(str(tmp_path / f"{i}.{n}.valid.tfrecord.gz")
                                 ) as write:
                for k in range(n):
                    write(f"# SEQ{i}{k}".encode())
        assert list(tfrecord_records(str(tmp_path))) == \
            list(jscoring.tfrecord_records(str(tmp_path)))
        with pytest.raises(FileNotFoundError):
            list(tfrecord_records(str(tmp_path), "train"))

    def test_names_and_ops_are_the_jax_packages(self):
        assert SCORE_OPS == jscoring.SCORE_OPS
        assert (tscoring._JOURNAL_NAME, tscoring._SHARD_FMT) == \
            (jscoring._JOURNAL_NAME, jscoring._SHARD_FMT)


class TestScoringWithinPort:
    def test_records_bit_equal_to_score_step(self, tmp_path, byte_pair):
        _, _, pm = byte_pair
        recs = _records(8, 8, 26, seed=1)
        run_batch_score(pm, recs, str(tmp_path), batch_size=4)
        by_id = {r["id"]: r for recs_ in _shards(tmp_path).values()
                 for r in recs_}
        for b in range(2):
            chunk = recs[4 * b:4 * b + 4]
            data = collate([raw for _, raw in chunk], BYTE["seq_len"])
            nll, lp, mask = score_step(pm, data, device="cpu")
            for i, (rid, _) in enumerate(chunk):
                rec = by_id[rid]
                assert rec["nll"] == float(nll[i])
                assert rec["logprobs"] == [float(x) for x in lp[i][mask[i]]]
                assert rec["n_tokens"] == int(mask[i].sum())

    def test_skips_too_long_records(self, tmp_path, byte_pair):
        _, _, pm = byte_pair
        recs = [("ok1", ("# " + _aa(np.random.default_rng(2), 10))
                 .encode()), ("long1", b"X" * (BYTE["seq_len"] + 5))]
        summary = run_batch_score(pm, recs, str(tmp_path), batch_size=2,
                                  resume=False)
        assert summary["n_scored"] == 1 and summary["n_skipped"] == 1
        (skip,) = [r for r in _journal(tmp_path) if r["op"] == "skip"]
        assert skip == {"ev": "score", "op": "skip", "id": "long1",
                        "n_tokens": BYTE["seq_len"] + 6,
                        "seq_len": BYTE["seq_len"]}

    @pytest.mark.parametrize("kw", [{}, {"prom_file": "p.prom"},
                                    {"prom_file": "p.prom",
                                     "metrics_every": 1}],
                             ids=["metrics", "prom_file", "metrics_every"])
    def test_prometheus_arguments_feed_the_exposition(self, tmp_path,
                                                      byte_pair, kw,
                                                      monkeypatch):
        """The scorer's registry counts what the JAX scorer's counts, on
        the same records (one too long), and its exposition is written on
        the same cadence with the same counter lines."""
        from progen_tpu.telemetry import MetricsRegistry as JRegistry

        from progen_tpu_torch.telemetry import MetricsRegistry

        jm, tree, pm = byte_pair
        recs = _records(5, 8, 20, seed=4) + [("long", b"X" * 40)]
        out = {}
        for name, fn, reg, mod in (
                ("jax", lambda **k: jscoring.run_batch_score(
                    jm, tree, list(recs), **k), JRegistry(), jscoring),
                ("port", lambda **k: run_batch_score(pm, list(recs), **k),
                 MetricsRegistry(), tscoring)):
            writes = []
            real = mod.write_prometheus
            monkeypatch.setattr(mod, "write_prometheus",
                                lambda p, t, real=real, w=writes:
                                (w.append(t), real(p, t)))
            k = dict(kw)
            if "prom_file" in k:
                k["prom_file"] = str(tmp_path / name / k["prom_file"])
            fn(out_dir=str(tmp_path / name), batch_size=2, metrics=reg, **k)
            out[name] = (reg.snapshot(), writes)
        (jsnap, jwrites), (psnap, pwrites) = out["jax"], out["port"]
        counters = ("sequences_scored", "tokens_scored", "batches",
                    "skipped_too_long")
        assert {c: psnap[c] for c in counters} == \
            {c: jsnap[c] for c in counters} == {
                "sequences_scored": 5.0, "tokens_scored": psnap[
                    "tokens_scored"], "batches": 3.0,
                "skipped_too_long": 1.0}
        assert set(psnap) == set(jsnap)
        assert len(pwrites) == len(jwrites) == {
            "metrics": 0, "prom_file": 1, "metrics_every": 4}[
            "metrics" if not kw else "prom_file" if len(kw) == 1
            else "metrics_every"]
        for pt, jt in zip(pwrites, jwrites):
            def counter_lines(t):
                return [ln for ln in t.splitlines() if "_total" in ln]
            assert counter_lines(pt) == counter_lines(jt)
            assert "progen_score_seq_per_s" in pt

    def test_journal_records_reach_the_telemetry_sink(self, tmp_path,
                                                      byte_pair):
        _, _, pm = byte_pair
        seen = []
        spans.configure(sink=seen.append)
        try:
            run_batch_score(pm, _records(3, 8, 20, seed=3), str(tmp_path),
                            batch_size=2)
        finally:
            spans.configure()
        # beside the scorer's spans (B and E records)
        assert [r["op"] for r in seen if r["ev"] == "score"] == [
            "start", "batch", "batch", "done"]
        assert {r["ev"] for r in seen} == {"score", "B", "E"}


class TestResume:
    def test_resume_after_max_batches(self, tmp_path, byte_pair):
        _, _, pm = byte_pair
        recs = _records(12, 8, 24, seed=3)
        partial = run_batch_score(pm, recs, str(tmp_path), batch_size=4,
                                  max_batches=1, shard_size=4)
        assert partial["stopped_early"] and partial["n_scored"] == 4
        full = run_batch_score(pm, recs, str(tmp_path), batch_size=4,
                               shard_size=4)
        assert full["n_resumed"] == 4 and full["n_scored"] == 8
        ids = _ids(tmp_path)
        assert sorted(ids) == sorted(r for r, _ in recs)
        assert len(ids) == len(set(ids))
        assert [r["op"] for r in _journal(tmp_path)] == \
            ["start", "batch", "done", "resume", "batch", "batch", "done"]

    def test_torn_tail_cut_and_scored_again(self, tmp_path, byte_pair):
        _, _, pm = byte_pair
        recs = _records(8, 8, 24, seed=4)
        run_batch_score(pm, recs, str(tmp_path), batch_size=4,
                        shard_size=100)
        shard = sorted(tmp_path.glob("scores-*.jsonl"))[0]
        lines = shard.read_text().splitlines(keepends=True)
        torn = json.loads(lines[-1])["id"]
        shard.write_text("".join(lines[:-1])
                         + lines[-1][:len(lines[-1]) // 2])
        seen, next_idx = scored_ids(str(tmp_path))
        assert torn not in seen and len(seen) == 7 and next_idx == 1
        assert shard.read_text().endswith("\n")  # the tail is cut off
        summary = run_batch_score(pm, recs, str(tmp_path), batch_size=4,
                                  shard_size=100)
        assert summary["n_scored"] == 1
        ids = _ids(tmp_path)
        assert sorted(ids) == sorted(r for r, _ in recs)
        assert len(ids) == len(set(ids))
        assert (tmp_path / "scores-00001.jsonl").exists()

    @pytest.mark.parametrize("first", ["jax", "port"])
    def test_resume_across_the_packages(self, tmp_path, byte_pair, first):
        """One package scores a batch and stops; the other resumes the
        same directory: every id once, the second package's records in a
        fresh shard."""
        jm, tree, pm = byte_pair
        recs = _records(10, 8, 24, seed=8)

        def jax_run(**kw):
            return jscoring.run_batch_score(jm, tree, list(recs),
                                            str(tmp_path), batch_size=4,
                                            **kw)

        def port_run(**kw):
            return run_batch_score(pm, list(recs), str(tmp_path),
                                   batch_size=4, **kw)

        runs = (jax_run, port_run) if first == "jax" else (port_run, jax_run)
        partial = runs[0](max_batches=1)
        assert partial["n_scored"] == 4
        rest = runs[1]()
        assert rest["n_resumed"] == 4 and rest["n_scored"] == 6
        ids = _ids(tmp_path)
        assert sorted(ids) == sorted(r for r, _ in recs)
        assert len(ids) == len(set(ids))
        assert sorted(_shards(tmp_path)) == ["scores-00000.jsonl",
                                             "scores-00001.jsonl"]


class TestBuckets:
    @pytest.mark.parametrize("fixed", [False, True],
                             ids=["pure_attention", "gmlp"])
    def test_bucket_matches_jax(self, fixed):
        for seq_len, minimum in ((64, 32), (1024, 512), (1024, 32)):
            for n in (1, 7, 31, 32, 33, 63, 64, 200, 511, 512, 513, 1024):
                want = jscoring._bucket(n, seq_len, minimum, fixed)
                assert tscoring._bucket(n, seq_len, minimum, fixed) == want

    def test_gmlp_models_score_at_seq_len(self, tmp_path, byte_pair):
        _, _, pm = byte_pair
        run_batch_score(pm, _records(3, 4, 10, seed=9), str(tmp_path),
                        batch_size=4)
        assert {r["bucket"] for r in _journal(tmp_path)
                if r["op"] == "batch"} == {BYTE["seq_len"]}


class TestScan:
    SEQ = "MKTAYI"

    def test_scan_matches_jax(self, byte_pair):
        jm, tree, pm = byte_pair
        for kw in ({}, {"positions": [1, 4], "context": "[tax=Homo]"}):
            want = jmut.mutagenesis_scan(jm, tree, self.SEQ, chunk=8,
                                         top=200, **kw)
            got = mutagenesis_scan(pm, self.SEQ, chunk=8, top=200, **kw)
            assert got["nll"].shape == want["nll"].shape
            np.testing.assert_allclose(got["nll"], want["nll"], **TOL)
            np.testing.assert_allclose(got["wt_nll"], want["wt_nll"], **TOL)
            for k in ("sequence", "context", "positions", "alphabet"):
                assert got[k] == want[k]
            assert len(got["top"]) == len(want["top"])

    def test_scan_matches_loop_reference(self, byte_pair):
        _, _, pm = byte_pair
        report = mutagenesis_scan(pm, self.SEQ, chunk=8, top=5)
        assert report["nll"].shape == (6, 20)
        for pos in range(6):
            for j in (0, 3, 11, 17):
                ref = reference_point_mutant_nll(
                    pm, self.SEQ, position=pos, aa=AA_ALPHABET[j])
                np.testing.assert_allclose(report["nll"][pos, j], ref,
                                           atol=1e-5, rtol=0)

    def test_loop_reference_matches_jax(self, byte_pair):
        jm, tree, pm = byte_pair
        for pos, aa in ((0, "W"), (3, "C")):
            np.testing.assert_allclose(
                reference_point_mutant_nll(pm, self.SEQ, position=pos,
                                           aa=aa, context="[tax=Homo]"),
                jmut.reference_point_mutant_nll(
                    jm, tree, self.SEQ, position=pos, aa=aa,
                    context="[tax=Homo]"), **TOL)

    def test_wild_type_from_the_same_batch(self, byte_pair):
        _, _, pm = byte_pair
        report = mutagenesis_scan(pm, self.SEQ, chunk=8)
        ref = reference_point_mutant_nll(pm, self.SEQ, position=0,
                                         aa=self.SEQ[0])
        np.testing.assert_allclose(report["wt_nll"], ref, atol=1e-5, rtol=0)

    def test_mutant_rows_are_the_loop_built_rows(self):
        row = torch.tensor([0, 36, 80, 77, 75, 33, 84, 0, 0])
        pos = torch.tensor([3, 5])
        aa = torch.tensor([66, 68, 69])
        rows = mutant_rows(row, pos, aa, chunk=4)
        assert rows.shape == (8, 9)  # 2 * 3 + 1 rows up to 4's multiple
        for i in range(8):
            want = row.clone()
            if i < 6:
                want[pos[i // 3]] = aa[i % 3]
            assert torch.equal(rows[i], want), i

    def test_top_excludes_self_substitutions(self, byte_pair):
        _, _, pm = byte_pair
        report = mutagenesis_scan(pm, self.SEQ, chunk=8, top=200)
        assert len(report["top"]) == 6 * 19
        for e in report["top"]:
            assert e["aa"] != self.SEQ[e["pos"]]
            assert e["wt"] == self.SEQ[e["pos"]]
        deltas = [e["delta_nll"] for e in report["top"]]
        assert deltas == sorted(deltas, reverse=True)

    def test_positions_subset_and_errors(self, byte_pair):
        _, _, pm = byte_pair
        report = mutagenesis_scan(pm, self.SEQ, positions=[4, 1, 4],
                                  chunk=8)
        assert report["positions"] == [1, 4]
        assert report["nll"].shape == (2, 20)
        for kw, match in (({"positions": [9]}, "outside"),
                          ({"positions": []}, "no positions")):
            with pytest.raises(ValueError, match=match):
                mutagenesis_scan(pm, self.SEQ, **kw)
        with pytest.raises(ValueError, match="empty"):
            mutagenesis_scan(pm, "")
        with pytest.raises(ValueError, match="seq_len"):
            mutagenesis_scan(pm, "M" * BYTE["seq_len"])


class TestChaos:
    @pytest.fixture(autouse=True)
    def _clean(self):
        yield
        chaos.uninstall()

    def test_parse_matches_jax(self):
        spec = ("score/batch:kill@2, serve/decode:0.25,"
                "serve/prefill:fail@3,train/loss:spike@2,serve/reload:nan@1,"
                "serve/prefill_chunk:kill")
        got = {k: (r.kind, r.arg) for k, r in chaos._parse(spec).items()}
        want = {k: (r.kind, r.arg) for k, r in jchaos._parse(spec).items()}
        assert got == want
        for bad in ("nocolon", "a:1.5"):
            with pytest.raises(ValueError):
                chaos._parse(bad)

    def test_fail_at_a_span_entry_and_a_call_site(self):
        seen = []
        spans.configure(sink=seen.append)
        try:
            chaos.install("serve/prefill:fail@2,score/batch:fail@1")
            with spans.span("serve/prefill"):
                pass
            with pytest.raises(chaos.ChaosError):
                with spans.span("serve/prefill"):
                    pass
            with pytest.raises(chaos.ChaosError):
                chaos.maybe_inject("score/batch")
            chaos.maybe_inject("score/batch")  # only the first hit
        finally:
            spans.configure()
        assert issubclass(chaos.ChaosError, chaos.TransientError)
        assert [r["site"] for r in seen if r["ev"] == "chaos"] == \
            ["serve/prefill", "score/batch"]
        assert [r["ev"] for r in seen if r.get("span")] == \
            ["B", "E", "B", "E"]

    def test_perturb_and_unknown_targets(self, monkeypatch):
        monkeypatch.setenv("PROGEN_CHAOS", "train/loss:spike@1,nope:kill")
        with pytest.warns(UserWarning, match="nope"):
            chaos.install_from_env()
        assert chaos.perturb("train/loss", 2.0) == 1e9
        assert chaos.perturb("train/loss", 2.0) == 2.0
        monkeypatch.setenv("PROGEN_CHAOS", "")
        assert chaos.install_from_env() is None
        assert chaos.maybe_inject not in spans.SPAN_ENTRY_HOOKS
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            chaos.maybe_inject("score/batch")  # uninstalled: a no-op

    def test_serving_sites_fire(self, byte_pair):
        from progen_tpu_torch.serving import Request, Scheduler, ServeEngine

        _, _, pm = byte_pair
        chaos.install("serve/decode:fail@3")
        sched = Scheduler(ServeEngine(pm, max_slots=1, max_len=24))
        assert sched.submit(Request(id="a", prime=np.array([5, 6]),
                                    length=20))[0]
        sched.step()
        sched.step()
        with pytest.raises(chaos.ChaosError):
            sched.step()
        chaos.install("serve/prefill:fail@1")
        sched = Scheduler(ServeEngine(pm, max_slots=1, max_len=24))
        sched.submit(Request(id="b", prime=np.array([5, 6]), length=20))
        with pytest.raises(chaos.ChaosError):
            sched.step()


def haiku_params(tree: dict, depth: int) -> dict:
    """The inverse of ``reference_params_to_flax``: a flax tree (unrolled)
    -> the reference's Haiku-named dict of numpy arrays."""
    p = "pro_gen_base/~"
    out = {f"{p}/embed": {"embeddings": tree["embed"]["embedding"]},
           f"{p}/layer_norm": {"scale": tree["ScaleNorm_0"]["norm"]["scale"]},
           f"{p}/linear": {"w": tree["to_logits"]["kernel"],
                           "b": tree["to_logits"]["bias"]}}
    for i in range(depth):
        a, f = tree[f"attn{i}"], tree[f"ff{i}"]
        out[f"{p}/attn{i}/~/layer_norm"] = {
            "scale": a["ScaleNorm_0"]["norm"]["scale"]}
        out[f"{p}/attn{i}/~/linear"] = {"w": a["to_qkv"]["kernel"]}
        out[f"{p}/attn{i}/~/linear_1"] = {"w": a["to_out"]["kernel"],
                                          "b": a["to_out"]["bias"]}
        out[f"{p}/ff{i}/~/layer_norm"] = {
            "scale": f["ScaleNorm_0"]["norm"]["scale"]}
        for mod, name in (("linear", "proj_in"), ("linear_1", "proj_out")):
            out[f"{p}/ff{i}/~/{mod}"] = {"w": f[name]["kernel"],
                                         "b": f[name]["bias"]}
        if "sgu" in f:
            s = f["sgu"]
            out[f"{p}/ff{i}/~/sgu"] = {
                "spatial_weights": s["spatial_weights"],
                "spatial_biases": s["spatial_biases"]}
            out[f"{p}/ff{i}/~/sgu/~/layer_norm"] = {
                "scale": s["ScaleNorm_0"]["norm"]["scale"]}
            out[f"{p}/ff{i}/~/sgu/~/linear"] = {
                "w": s["proj_out"]["kernel"], "b": s["proj_out"]["bias"]}
    return out


class TestConvert:
    def _pickle(self, tmp_path, byte_pair, params=None):
        _, tree, _ = byte_pair
        src = tmp_path / "ckpt_1700000000.pkl"
        package = {"next_seq_index": 4096,
                   "params": params or haiku_params(tree, BYTE["depth"]),
                   "optim_state": None, "model_config": dict(BYTE),
                   "run_id": "ref-run-7"}
        src.write_bytes(pickle.dumps(package))
        return src, package

    def test_mapping_is_the_jax_packages(self, byte_pair):
        _, tree, _ = byte_pair
        ref = haiku_params(tree, BYTE["depth"])
        got = tconvert.reference_params_to_flax(ref, BYTE["depth"])
        want = jconvert.reference_params_to_flax(ref, BYTE["depth"])
        flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        for (path, g), (_, w) in zip(flat_got, flat_want):
            assert g.dtype == w.dtype and np.array_equal(g, w), path

    def test_converted_checkpoint_is_bit_equal(self, tmp_path, byte_pair):
        src, package = self._pickle(tmp_path, byte_pair)
        written = tconvert.convert_checkpoint(str(src), str(tmp_path / "ck"),
                                              device="cpu")
        want = tconvert.flax_params_to_state_dict(
            jconvert.reference_params_to_flax(package["params"],
                                              BYTE["depth"]),
            ProGenConfig(**BYTE))
        _, get_last, _ = get_checkpoint_fns(str(tmp_path / "ck"))
        pkg = get_last(device="cpu")
        assert pkg.path == written
        assert (pkg.next_seq_index, pkg.run_id) == (4096, "ref-run-7")
        assert ProGenConfig.from_dict(pkg.model_config) == \
            ProGenConfig(**BYTE)
        assert pkg.state["params"].keys() == want.keys()
        for k, v in want.items():
            got = pkg.state["params"][k]
            assert got.dtype == v.dtype and torch.equal(got, v), k
        opt = pkg.state["optimizer"]
        assert opt["count"] == 0 and pkg.state["step"] == 0
        assert all(not m.any() for m in opt["mu"].values())
        assert all(not m.any() for m in opt["nu"].values())

    def test_rejects_a_leaf_that_is_no_numpy_array(self, tmp_path,
                                                   byte_pair):
        _, tree, _ = byte_pair
        ref = haiku_params(tree, BYTE["depth"])
        ref["pro_gen_base/~/embed"]["embeddings"] = \
            ref["pro_gen_base/~/embed"]["embeddings"].tolist()
        src, _ = self._pickle(tmp_path, byte_pair, ref)
        with pytest.raises(ValueError, match="not a numpy array"):
            tconvert.convert_checkpoint(str(src), str(tmp_path / "ck"),
                                        device="cpu")
        assert not (tmp_path / "ck").exists()

    def test_rejects_what_is_no_reference_checkpoint(self, tmp_path):
        src = tmp_path / "x.pkl"
        src.write_bytes(pickle.dumps({"params": {}}))
        with pytest.raises(ValueError, match="not a reference checkpoint"):
            tconvert.load_reference_package(str(src))

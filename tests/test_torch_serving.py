"""The port's serving engine and its sampler, on the CPU, against the JAX
package and against the port's own ``sample_fast``.

Config: the JAX serving tests' tiny model (vocab 32, dim 32, seq_len 32,
depth 2, window 8, one gMLP layer, heads 2, dim_head 16, ff_mult 2) in
float32. Weights come from the JAX model's init, with the SGU weights
and biases and the norm scales redrawn from numpy so that every one
matters, and go to the port through ``convert.py``.

Tolerances: logits against JAX's decoder 1e-5 absolute (two layers of
float32 sums in different orders); the embedding 1e-5 absolute. Token
streams are compared bit for bit. A row's logits in a batch differ from
the same row's alone in the last bits (the CPU's matrix products take
another path for one row than for several), so rows are held to 1e-5
there and their streams bit for bit.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu import config as jcfg
from progen_tpu import sampling as jsampling
from progen_tpu.models.progen import ProGen as JProGen
from progen_tpu.models.progen import decode_model
from progen_tpu.serving import ServeEngine as JServeEngine
from progen_tpu_torch import ProGen, ProGenConfig
from progen_tpu_torch import sampling as tsampling
from progen_tpu_torch.convert import flax_params_to_state_dict
from progen_tpu_torch.serving import (
    PrefixCache,
    Request,
    Scheduler,
    ServeEngine,
)
from progen_tpu_torch.workloads.infill import (
    infill_request_arrays,
    parse_template,
)

TINY = dict(num_tokens=32, dim=32, seq_len=32, depth=2, window_size=8,
            global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2,
            dtype="float32")
ATOL = 1e-5
OFF = tsampling._TOP_P_OFF


def _jax_params(cfg, seed=0) -> dict:
    params = flax.linen.meta.unbox(jax.jit(JProGen(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg.seq_len), jnp.int32)
    )["params"])
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name, a = path[-1].key, np.asarray(leaf)
        if name == "spatial_weights":
            return (rng.standard_normal(a.shape) / np.sqrt(cfg.seq_len)
                    ).astype(a.dtype)
        if name == "spatial_biases":
            return rng.standard_normal(a.shape).astype(a.dtype)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(redraw, params)


@pytest.fixture(scope="module")
def setup():
    """(JAX model, its params, the port's model on the same weights)."""
    jm = JProGen(jcfg.ProGenConfig(**TINY))
    tree = _jax_params(jm.config)
    cfg = ProGenConfig(**TINY)
    pm = ProGen(cfg, device="cpu", seed=None)
    pm.load_state_dict(flax_params_to_state_dict(tree, cfg))
    return jm, tree, pm.eval()


def _reference(pm, req: Request) -> np.ndarray:
    """The request's stream from the standalone decoder."""
    return tsampling.sample_fast(
        req.seed, pm, req.prime, req.length, top_k=req.top_k,
        add_bos=req.add_bos, temperature=req.temperature, top_p=req.top_p,
        template=req.template, frozen=req.frozen, device="cpu").numpy()


def _mixed_requests(n: int, seed: int = 7) -> list:
    """n overlapping requests of mixed lengths and knobs, every fourth an
    infill of about a third frozen positions."""
    rng = np.random.RandomState(seed)
    knobs = [{}, {"temperature": 0.7}, {"top_p": 0.9}, {"top_k": None},
             {"temperature": 1.3, "top_p": 0.8, "top_k": 5}, {"top_k": 3},
             {"temperature": 0.5, "top_k": 10}, {"add_bos": True}]
    reqs = []
    for i in range(n):
        k = dict(knobs[i % len(knobs)])
        if i % 4 == 3:
            k.pop("add_bos", None)
            width = int(rng.randint(8, 28))
            frozen = list(rng.rand(width) < 0.35)
            frozen[0] = True
            toks = [int(t) if f else 0
                    for t, f in zip(rng.randint(1, 32, width), frozen)]
            prime, length, tpl, frz = infill_request_arrays(toks, frozen)
            reqs.append(Request(id=f"r{i}", prime=prime, length=length,
                                add_bos=True, template=tpl, frozen=frz,
                                seed=1000 + i, **k))
            continue
        plen = int(rng.randint(1, 8))
        prime = rng.randint(1, 32, size=plen)
        length = int(rng.randint(plen + 2 + k.get("add_bos", False), 30))
        reqs.append(Request(id=f"r{i}", prime=prime, length=length,
                            seed=1000 + i, **k))
    return reqs


def _serve(pm, reqs, **kw) -> dict:
    slots = kw.pop("max_slots", 4)
    sched = Scheduler(ServeEngine(pm, max_slots=slots, max_len=32), **kw)
    for r in reqs:
        assert sched.submit(r) == (True, None)
    _, comps = sched.run_to_completion(max_steps=5000)
    assert not sched.engine.slots.live.any()
    assert sorted(sched.engine._free) == list(range(slots))
    return {c.request_id: c.tokens for c in comps}


class TestPerRowDecoder:
    OFFSETS = (0, 3, 9, 14)  # each row's tokens fed alone before joining
    JOINT = 12  # steps all rows then take together

    def _tokens(self):
        return np.random.default_rng(3).integers(1, 32, (4, 32))

    def _port_rows(self, pm, toks):
        """The rows' logits over the joint steps, decoded in one batch
        at staggered positions."""
        pool = pm.init_cache(4)
        with torch.no_grad():
            for r, off in enumerate(self.OFFSETS):
                one = pm.init_cache(1)
                for p in range(off):
                    pm.decode_step(torch.tensor([toks[r, p]]), one)
                pool.set_row_(r, one)
            pos = np.array(self.OFFSETS)
            out = []
            for t in range(self.JOINT):
                step = torch.from_numpy(toks[np.arange(4), pos + t])
                out.append(pm.decode_step(step, pool))
        assert pool.pos.tolist() == [o + self.JOINT for o in self.OFFSETS]
        return torch.stack(out, 1).numpy()

    def test_staggered_rows_match_jax_batch1_decode(self, setup):
        jm, tree, pm = setup
        toks = self._tokens()
        got = self._port_rows(pm, toks)
        # JAX: the engine's path, a batch-1 apply vmapped over the rows'
        # stacked caches
        dm = decode_model(jm)
        params = jax.tree.map(jnp.asarray, tree)

        def one(cache, tok):
            logits, mut = dm.apply({"params": params, "cache": cache},
                                   tok[None, None], mutable=["cache"])
            return logits[0, 0], mut["cache"]

        step1, stepv = jax.jit(one), jax.jit(jax.vmap(one))
        caches = []
        for r, off in enumerate(self.OFFSETS):
            c = dm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 1), jnp.int32))["cache"]
            for p in range(off):
                _, c = step1(c, jnp.int32(toks[r, p]))
            caches.append(c)
        cache = jax.tree.map(lambda *xs: jnp.stack(xs), *caches)
        pos = np.array(self.OFFSETS)
        for t in range(self.JOINT):
            want, cache = stepv(cache, jnp.asarray(
                toks[np.arange(4), pos + t], jnp.int32))
            np.testing.assert_allclose(got[:, t], np.asarray(want),
                                       atol=ATOL, rtol=0)

    def test_row_in_a_batch_equals_the_row_alone(self, setup):
        _, _, pm = setup
        toks = self._tokens()
        batch = self._port_rows(pm, toks)
        for r, off in enumerate(self.OFFSETS):
            one = pm.init_cache(1)
            with torch.no_grad():
                alone = torch.stack([
                    pm.decode_step(torch.tensor([toks[r, p]]), one)[0]
                    for p in range(off + self.JOINT)])[off:].numpy()
            np.testing.assert_allclose(batch[r], alone, atol=ATOL, rtol=0)
            # the same draws over either pick the same tokens
            noise = tsampling.seeded_noise([r] * self.JOINT,
                                           range(self.JOINT), 32)
            pick = [tsampling.gumbel_topk_step(torch.from_numpy(x), 5, noise)
                    for x in (batch[r], alone)]
            assert torch.equal(*pick)

    def test_set_row_resets_and_row_is_a_copy(self, setup):
        _, _, pm = setup
        pool = pm.init_cache(3)
        with torch.no_grad():
            for p in range(10):
                pm.decode_step(torch.tensor([1, 2, 3]), pool)
        snap = pool.row(1)
        assert snap.pos.tolist() == [10]
        assert all(a.data_ptr() != b.data_ptr()
                   for a, b in zip(snap.tensors(), pool.tensors()))
        pool.set_row_(1, pm.init_cache(1))
        assert pool.pos.tolist() == [10, 0, 10]
        ring = pool.attn[0].slot_pos
        assert (ring[1] == -1).all() and ring[0].tolist() == ring[2].tolist()
        assert ring[0].max() == 9
        assert pool.ff[1].gate_history[1].abs().sum() == 0
        assert snap.attn[0].slot_pos.max() == 9


    def test_host_bound_checks_seq_len_without_reading_the_device(
            self, setup):
        _, _, pm = setup
        pool = pm.init_cache(2)
        pool.place_(torch.tensor([31, 5]), top=31)
        with torch.no_grad():
            pm.decode_step(torch.tensor([1, 2]), pool)
        assert pool.top == 32 and pool.pos.tolist() == [32, 6]
        with pytest.raises(ValueError, match="past seq_len"):
            pm.decode_step(torch.tensor([1, 2]), pool)
        # a row copied in carries its bound; a copy keeps it
        one = pm.init_cache(2)
        one.set_row_(0, pool.row(0))
        assert one.top == 32 and one.clone().top == 32
        with pytest.raises(TypeError):
            one.pos = torch.tensor([0, 0])


class TestDynamicSampler:
    GRID = [(k, parity, temp, p) for k in (0, 1, 5, 32)
            for parity in (True, False) for temp in (0.5, 1.0, 1.7)
            for p in (0.3, 0.9, OFF)]

    @pytest.mark.parametrize("logit_seed", [0, 1, 2])
    def test_matches_jax_given_its_noise(self, logit_seed):
        rows = len(self.GRID)
        logit = (np.random.default_rng(logit_seed)
                 .standard_normal((rows, 32)) * 3).astype(np.float32)
        k, parity, temp, top_p = (np.array(c) for c in zip(*self.GRID))
        keys = jax.random.split(jax.random.PRNGKey(logit_seed), rows)
        _, want = jax.vmap(jsampling.gumbel_step_dynamic)(
            keys, jnp.asarray(logit), jnp.asarray(k, jnp.int32),
            jnp.asarray(parity), jnp.asarray(temp, jnp.float32),
            jnp.asarray(top_p, jnp.float32))
        noise = np.stack([np.asarray(jsampling.gumbel_noise(
            jax.random.split(key)[1], (32,))) for key in keys])
        got = tsampling.gumbel_step_dynamic(
            torch.from_numpy(noise), torch.from_numpy(logit),
            torch.from_numpy(k), torch.from_numpy(parity),
            torch.from_numpy(temp.astype(np.float32)),
            torch.from_numpy(top_p.astype(np.float32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("logit_seed", [0, 1, 2])
    def test_equals_the_static_step_for_every_setting(self, logit_seed):
        rng = np.random.default_rng(logit_seed)
        logit = torch.from_numpy(
            (rng.standard_normal((len(self.GRID), 32)) * 3)
            .astype(np.float32))
        noise = tsampling.seeded_noise(range(len(self.GRID)),
                                       [logit_seed] * len(self.GRID), 32)
        k, parity, temp, top_p = zip(*self.GRID)
        got = tsampling.gumbel_step_dynamic(
            noise, logit, torch.tensor(k), torch.tensor(parity),
            torch.tensor(temp), torch.tensor(top_p))
        for i, (ki, par, t, p) in enumerate(self.GRID):
            want = tsampling.gumbel_topk_step(
                logit[i:i + 1], ki or None, noise[i:i + 1], par, t, p)
            assert got[i] == want[0], self.GRID[i]


def _jax_noise(seed: int, draws: int) -> np.ndarray:
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(draws):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jsampling.gumbel_noise(sub, (32,))))
    return np.stack(out)


class TestInfill:
    @pytest.mark.parametrize("template,top_k", [("MK?LV??GA?", 25),
                                                ("M??????K?L", None),
                                                ("?K?E??", 5)])
    def test_sample_fast_matches_jax(self, setup, template, top_k):
        jm, tree, pm = setup
        toks, frz = parse_template(template)
        toks = [t % 31 + 1 if f else 0 for t, f in zip(toks, frz)]
        prime, length, tpl, frozen = infill_request_arrays(toks, frz)
        noise = _jax_noise(9, length)
        want = jsampling.sample_fast(
            jax.random.PRNGKey(9), jm, tree, jnp.asarray(prime), length,
            top_k=top_k, add_bos=True, template=jnp.asarray(tpl),
            frozen=jnp.asarray(frozen))
        got = tsampling.sample_fast(0, pm, prime, length, top_k=top_k,
                                    add_bos=True, template=tpl,
                                    frozen=frozen, device="cpu",
                                    noise=lambda i: noise[i])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy()[frozen] == tpl[frozen]).all()

    def test_rejects_bad_templates(self, setup):
        _, _, pm = setup
        tpl, frz = np.zeros(8, np.int64), np.zeros(8, bool)
        for bad in (dict(template=tpl), dict(template=tpl[:5], frozen=frz),
                    dict(template=tpl, frozen=~frz)):
            with pytest.raises(ValueError):
                tsampling.sample_fast(0, pm, [3], 8, device="cpu", **bad)


class TestEngine:
    @pytest.mark.parametrize("slots", [1, 2, 4])
    def test_mixed_requests_equal_sample_fast(self, setup, slots):
        _, _, pm = setup
        reqs = _mixed_requests(12)
        got = _serve(pm, reqs, max_slots=slots)
        for r in reqs:
            np.testing.assert_array_equal(got[r.id], _reference(pm, r),
                                          err_msg=r.id)
        assert any(r.template is not None for r in reqs)

    @pytest.mark.parametrize("slots", [1, 2])
    def test_slot_reuse_after_eos_is_bit_equal(self, setup, slots):
        """An occupant with top_k = 1 draws EOS at once (its second zero
        after BOS), so the next request lands on its slot, reset from the
        fresh template. No seed is searched for."""
        _, _, pm = setup
        occupant = Request(id="eos", prime=[5, 6], length=20, top_k=1,
                           add_bos=True, seed=3)
        nxt = Request(id="next", prime=[7, 8, 9], length=24,
                      temperature=0.8, top_p=0.95, seed=4)
        engine = ServeEngine(pm, max_slots=slots, max_len=32)
        sched = Scheduler(engine)
        sched.submit(occupant)
        events, comps = sched.step()
        assert [c.request_id for c in comps] == ["eos"]
        assert events[0].token == 0 and comps[0].n_generated == 1
        np.testing.assert_array_equal(comps[0].tokens,
                                      _reference(pm, occupant))
        sched.submit(nxt)
        sched.step()
        assert sched._active[0].req.id == "next"  # the occupant's slot
        _, comps = sched.run_to_completion(max_steps=100)
        np.testing.assert_array_equal(comps[-1].tokens, _reference(pm, nxt))
        np.testing.assert_array_equal(engine.collect(0)[:3], [7, 8, 9])

    @pytest.mark.parametrize("chunk", [1, 3, 7])
    def test_chunked_prefill_equals_monolithic(self, setup, chunk):
        _, _, pm = setup
        reqs = _mixed_requests(8, seed=11)
        mono = _serve(pm, reqs, max_slots=2)
        chunked = _serve(pm, reqs, max_slots=2, prefill_chunk=chunk)
        for r in reqs:
            np.testing.assert_array_equal(chunked[r.id], mono[r.id])

    @pytest.mark.parametrize("knobs", [{}, {"temperature": 0.6,
                                            "top_p": 0.9}])
    def test_prefix_hit_equals_cold(self, setup, knobs):
        _, _, pm = setup
        scaffold = list(np.random.default_rng(5).integers(1, 32, 17))
        first = Request(id="a", prime=scaffold + [3, 4], length=30, seed=1)
        second = Request(id="b", prime=scaffold + [9], length=28, seed=2,
                         **knobs)
        cache = PrefixCache(1 << 20)
        engine = ServeEngine(pm, max_slots=2, max_len=32)
        sched = Scheduler(engine, prefill_chunk=4, prefix_cache=cache)
        sched.submit(first)
        sched.run_to_completion(max_steps=200)
        before = sched.metrics.counters["prefill_tokens"]
        sched.submit(second)
        _, comps = sched.run_to_completion(max_steps=200)
        # the first request's chunk boundaries 4, 8, ..., 16 and its end,
        # 18, are stored; the second (feed region 17) hits at 16
        assert cache.hits == 1 and engine.prefix_cache is cache
        assert sched.metrics.counters["prefix_cache_hit_tokens"] == 16
        assert sched.metrics.counters["prefill_tokens"] - before == 1
        cold = _serve(pm, [second], max_slots=2)
        np.testing.assert_array_equal(comps[0].tokens, cold["b"])
        np.testing.assert_array_equal(comps[0].tokens, _reference(pm,
                                                                  second))

    def test_prefill_admits_a_slot_directly(self, setup):
        _, _, pm = setup
        engine = ServeEngine(pm, max_slots=2, max_len=32)
        reqs = [r for r in _mixed_requests(6) if r.template is None][:2]
        for r in reqs:
            slot = engine.acquire()
            start = engine.prefill(
                slot, r.prime, r.length, top_k=r.top_k, add_bos=r.add_bos,
                temperature=r.temperature, top_p=r.top_p, seed=r.seed)
            assert start == len(r.prime) + r.add_bos
        done = set()
        while len(done) < len(reqs):
            _, _, finished = engine.decode_step()
            done |= set(np.flatnonzero(finished).tolist())
        for slot, r in enumerate(reqs):
            np.testing.assert_array_equal(engine.collect(slot),
                                          _reference(pm, r))

    def test_commit_params_swaps_weights_and_clears_snapshots(self, setup):
        _, _, pm = setup
        model = ProGen(pm.config, device="cpu", seed=None)
        model.load_state_dict(pm.state_dict())
        engine = ServeEngine(model, max_slots=1, max_len=32)
        cache = PrefixCache(1 << 20)
        engine.set_prefix_cache(cache)
        sched = Scheduler(engine, prefix_cache=cache)
        sched.submit(Request(id="a", prime=[4, 5, 6, 7], length=12))
        sched.run_to_completion(max_steps=50)
        assert len(cache) == 1
        other = ProGen(pm.config, device="cpu", seed=11).state_dict()
        prepared = engine.prepare_params(other)
        assert len(cache) == 1 and torch.equal(model.embed, pm.embed)
        engine.commit_params(prepared)
        assert len(cache) == 0 and cache.bytes == 0
        assert torch.equal(model.embed, other["embed"])

    def test_prepare_params_rejects_another_shape(self, setup):
        _, _, pm = setup
        engine = ServeEngine(pm, max_slots=1, max_len=32)
        wide = ProGen(ProGenConfig(**{**TINY, "dim": 64}), device="cpu")
        with pytest.raises(ValueError, match="incompatible"):
            engine.prepare_params(wide.state_dict())
        sd = dict(pm.state_dict())
        sd.pop("embed")
        with pytest.raises(ValueError, match="names differ"):
            engine.prepare_params(sd)
        sd = dict(pm.state_dict(), embed=pm.embed.double())
        with pytest.raises(ValueError, match="embed"):
            engine.prepare_params(sd)

    def test_embed_matches_jax_engine(self, setup):
        jm, tree, pm = setup
        prime = np.random.default_rng(2).integers(1, 32, 13)
        jengine = JServeEngine(jm, tree, max_slots=1)
        engine = ServeEngine(pm, max_slots=1)
        for add_bos in (True, False):
            want = jengine.embed(prime, add_bos=add_bos)
            got = engine.embed(prime, add_bos=add_bos)
            assert got.dtype == np.float32 and got.shape == (32,)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    def test_rejects_what_it_cannot_serve(self, setup):
        _, _, pm = setup
        with pytest.raises(ValueError, match="int8"):
            ServeEngine(pm, quantize_int8=True)
        for bad in (dict(max_slots=0), dict(max_len=1), dict(max_len=33)):
            with pytest.raises(ValueError):
                ServeEngine(pm, **bad)
        engine = ServeEngine(pm, max_slots=1, max_len=16)
        for prime, length, kw in (([1], 20, {}), ([1], 8, {"top_k": 0}),
                                  ([1] * 8, 8, {}), ([1], 8,
                                                     {"top_p": 1.5})):
            with pytest.raises(ValueError):
                engine.validate(prime, length, **kw)

"""Slot-pool continuous-batching engine over the KV-cache decoder.

The port of the JAX package's ``serving/engine.py``. The single-shot
decoders (``sampling.sample_fast``) run one request set to completion;
a server's requests arrive and finish at different times. This engine
keeps a fixed pool of ``max_slots`` decode lanes on the device (the
slot-pool idea of vLLM, at one request a slot) and advances every live
lane one token per ``decode_step`` call (the iteration-level scheduling
of Orca).

Per-slot positions: the pool is one ``DecodeCache`` of batch
``max_slots`` whose rows stand at their own positions (the model's
decoder takes a (batch,) position tensor), where the JAX engine
``vmap``s a batch-1 apply over stacked caches. Dead slots compute too,
at position 0, and their writes to the token buffers are masked; that
is safe because an admission copies a fresh batch-1 template into the
slot's row (a reset: the ring's slots hold position -1 again) before the
row is read.

Sampling knobs ride as per-slot tensors (``gumbel_step_dynamic``), so
one step serves any mix of temperature, top_k and top_p. Each slot
follows its request's own stream: draw t comes from a CPU generator
seeded with ``draw_seed(seed, draw_offset + t)`` (the port's RNG rule,
``sampling.py``), so a request decoded here gets the tokens of
``sample_fast(seed, ...)``: bit for bit on the CPU and, with one slot,
on the card; with several slots the card's bfloat16 products may round
otherwise than at batch 1, and a draw at a near tie can then go the
other way. A slot's seed and draw counter live on the host, where the
noise is drawn; everything else of the pool lies on the device.

There is no compilation here, so the JAX engine's
``decode_compile_count``/``prefill_compile_count`` have no counterpart.

int8 serving (``quantize_int8``): the matrix-product weights are kept on
the device as int8 with per-output-channel scales (``ops/quant.py``),
beside the model's full-precision weights, which the embedding reads.
Every decode step, and every prefill chunk, dequantises them into the
compute dtype and runs the shared step with them in place of the model's
own (``torch.func.functional_call``), as the JAX engine's int8 programs
run ``dequantize_tree`` and then the shared body; the dequantised weights
live for that call only. ``quant_report`` holds the JAX engine's
calibration: each leaf's weight error and the worst logit gap over a
fixed prompt through a fresh cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from progen_tpu_torch.models.progen import DecodeCache
from progen_tpu_torch.ops.quant import dequantize_tree, quantize_tree
from progen_tpu_torch.sampling import (
    _TOP_P_OFF,
    _constrain,
    _prepare_seq,
    _validate_infill,
    _validate_knobs,
    gumbel_step_dynamic,
    seeded_noise,
)
from progen_tpu_torch.telemetry.spans import span
from progen_tpu_torch.workloads.embeddings import bucket_length, embed_step


class PreparedParams(NamedTuple):
    """A checkpoint's parameters, checked against the served model and on
    its device (``ServeEngine.prepare_params``), waiting for
    ``commit_params`` between decode steps; under int8 serving also
    their quantised weights, scales and calibration report."""

    params: dict
    q_params: Optional[dict] = None
    q_scales: Optional[dict] = None
    quant_report: Optional[dict] = None


class _DecodeCall(nn.Module):
    """The model's ``decode_step`` as a module's forward, so
    ``torch.func.functional_call`` can run it with other weights."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens, cache):
        return self.model.decode_step(tokens, cache)


@dataclasses.dataclass
class SlotBatch:
    """The pool's state; every tensor's leading axis is the slot."""

    cache: DecodeCache  # batch max_slots, each row at its own position
    seqs: torch.Tensor  # (S, L) int64 token buffers (right-padded with 0)
    cur: torch.Tensor  # (S,) int64 position of the last written token
    nz: torch.Tensor  # (S,) int64 zero tokens seen (BOS first, EOS second)
    target: torch.Tensor  # (S,) int64 requested total length
    temp: torch.Tensor  # (S,) float32 temperature
    top_p: torch.Tensor  # (S,) float32 nucleus mass (_TOP_P_OFF = off)
    top_k: torch.Tensor  # (S,) int64 (0 = off)
    parity: torch.Tensor  # (S,) bool: the reference-quirk sampling branch
    live: torch.Tensor  # (S,) bool: the slot is decoding
    template: torch.Tensor  # (S, L) int64 infill template (all 0 = off)
    frozen: torch.Tensor  # (S, L) bool infill frozen positions
    seed: list  # host: each slot's stream seed
    draws: list  # host: each slot's next draw index


@dataclasses.dataclass
class PendingPrefill:
    """An admission in progress: the request's slot state and the
    batch-1 cache being fed. It stays outside the pool until its last
    chunk, so decode steps between chunks never see a half-primed slot.
    ``pos`` counts the prime positions fed; the feed region is
    ``row[0:start-1]`` (the last prime token is fed by the first decode
    step)."""

    slot: int
    row: np.ndarray  # (max_len,) int64 token buffer
    tokens: torch.Tensor  # the same on the device
    start: int  # primed positions
    length: int  # requested total length (the slot's target)
    seed: int
    draw_offset: int  # the stream's first draw index
    temperature: float
    top_p_val: float  # _TOP_P_OFF when off
    top_k_val: int  # 0 when off
    parity: bool
    trow: np.ndarray  # (max_len,) int64 infill template row
    frow: np.ndarray  # (max_len,) bool infill frozen row
    cache: Any  # batch-1 DecodeCache fed through ``pos`` positions
    pos: int = 0
    hit_depth: int = 0  # prefix-cache depth it started from (0 = cold)
    request_id: str = ""
    done: bool = False

    @property
    def feed_len(self) -> int:
        return max(self.start - 1, 0)


class ServeEngine:
    """Fixed-pool continuous-batching engine bound to one (model,
    max_slots, max_len). The host keeps a free list and each slot's
    stream position; the decode state lives on the model's device in
    ``self.slots``."""

    @torch.inference_mode()
    def __init__(self, model, *, max_slots: int = 8,
                 max_len: Optional[int] = None,
                 quantize_int8: bool = False):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        seq_len = model.config.seq_len
        self.max_len = int(max_len or seq_len)
        if not 2 <= self.max_len <= seq_len:
            raise ValueError(
                f"max_len must be in [2, seq_len={seq_len}], got "
                f"{self.max_len}"
            )
        self.max_slots = int(max_slots)
        self.model = model
        self.device = model.device
        self.fresh_cache = model.init_cache(1)
        s, n = self.max_slots, self.max_len

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.slots = SlotBatch(
            cache=model.init_cache(s),
            seqs=zeros(s, n), cur=zeros(s), nz=zeros(s),
            target=torch.full((s,), n, device=self.device),
            temp=torch.ones(s, device=self.device),
            top_p=torch.full((s,), _TOP_P_OFF, device=self.device),
            top_k=zeros(s),
            parity=torch.ones(s, dtype=torch.bool, device=self.device),
            live=zeros(s, dtype=torch.bool),
            template=zeros(s, n), frozen=zeros(s, n, dtype=torch.bool),
            seed=[0] * s, draws=[0] * s,
        )
        self._rows = torch.arange(s, device=self.device)
        self._free = list(range(s))
        self._live = [False] * s  # host mirror of slots.live
        self._cur = [0] * s  # host mirror of slots.cur
        self._targets = [n] * s  # host mirror for collect()
        self._prefix_cache = None
        self._call = _DecodeCall(model)
        self.quantize_int8 = bool(quantize_int8)
        self.quant_report = None
        self._q_params = self._q_scales = None
        if self.quantize_int8:
            params = model.state_dict()
            self._q_params, self._q_scales, leaves = quantize_tree(
                params, model.config)
            self.quant_report = self._calibrate(
                leaves, params, self._q_params, self._q_scales)

    # ----- int8 weights ---

    def _dequantized(self, q_params: dict, q_scales: dict) -> dict:
        """The quantised weights in the compute dtype, by name, for one
        call."""
        deq = dequantize_tree({k: q_params[k] for k in q_scales}, q_scales,
                              self.model.config.compute_dtype)
        return {f"model.{k}": v for k, v in deq.items()}

    def _decoder(self):
        """The decode step to run now: the model's own, or under int8
        serving the same step with freshly dequantised weights in place
        of the model's."""
        if not self.quantize_int8:
            return self.model.decode_step
        weights = self._dequantized(self._q_params, self._q_scales)
        return lambda tokens, cache: torch.func.functional_call(
            self._call, weights, (tokens, cache))

    @torch.inference_mode()
    def _calibrate(self, leaves: list, params: dict, q_params: dict,
                   q_scales: dict) -> dict:
        """The int8 path's accuracy record: each quantised leaf's weight
        max-abs-error, and the worst logit max-abs-error of the
        dequantised weights against ``params`` over the fixed prompt
        (1, 7, 23, 4) fed through a fresh cache (the op sequence decode
        runs). It takes the weights explicitly, so a weight swap can
        calibrate candidate weights while the live ones keep serving."""
        full = {f"model.{k}": v for k, v in params.items()}
        deq = {**full, **self._dequantized(q_params, q_scales)}
        cache_a, cache_b = self.fresh_cache.clone(), self.fresh_cache.clone()
        worst = 0.0
        for tok in (1, 7, 23, 4):
            t = torch.full((1, 1), tok, dtype=torch.long, device=self.device)
            la = torch.func.functional_call(self._call, full, (t, cache_a))
            lb = torch.func.functional_call(self._call, deq, (t, cache_b))
            worst = max(worst, float((la.float() - lb.float()).abs().max()))
        return {
            "bits": 8,
            "scheme": "per-channel symmetric, weights only",
            "quantized_leaves": len(leaves),
            "bytes_fp": sum(leaf["bytes_fp"] for leaf in leaves),
            "bytes_int8": sum(leaf["bytes_int8"] for leaf in leaves),
            "weight_max_abs_err": max(
                (leaf["max_abs_err"] for leaf in leaves), default=0.0),
            "logits_max_abs_err": worst,
            "leaves": leaves,
        }

    @property
    def quantized_nbytes(self) -> int:
        """Device bytes of the int8 weights and their scales (0 when the
        engine serves the model's own weights)."""
        if not self.quantize_int8:
            return 0
        return sum(self._q_params[k].nbytes + v.nbytes
                   for k, v in self._q_scales.items())

    # ----- weight swap ---

    @torch.inference_mode()
    def prepare_params(self, state_dict: dict) -> PreparedParams:
        """Check a restored state dict against the served model (the same
        names, and each tensor's shape and dtype) and move it to the
        model's device; under int8 serving quantise and calibrate it
        again. Anything else raises ValueError: a model of another shape
        needs a new engine. Touches no engine state."""
        live = self.model.state_dict()
        if set(state_dict) != set(live):
            missing = sorted(set(live) - set(state_dict))
            extra = sorted(set(state_dict) - set(live))
            raise ValueError(
                "incompatible checkpoint: parameter names differ from the "
                f"served model's (missing {missing[:3]}, extra {extra[:3]})"
            )
        for name, t in live.items():
            cand = state_dict[name]
            if cand.shape != t.shape or cand.dtype != t.dtype:
                raise ValueError(
                    f"incompatible checkpoint: {name} is "
                    f"{tuple(cand.shape)}/{cand.dtype}, the served model's "
                    f"is {tuple(t.shape)}/{t.dtype}"
                )
        params = {k: v.to(self.device) for k, v in state_dict.items()}
        if not self.quantize_int8:
            return PreparedParams(params)
        q_params, q_scales, leaves = quantize_tree(params, self.model.config)
        return PreparedParams(params, q_params, q_scales, self._calibrate(
            leaves, params, q_params, q_scales))

    def commit_params(self, prepared: PreparedParams) -> None:
        """Copy the prepared weights into the served model (and its int8
        weights into place), between two decode steps. Requests in flight
        go on with their caches; the prefix cache's snapshots were
        computed under the old weights and are dropped."""
        self.model.load_state_dict(prepared.params)
        if self.quantize_int8:
            self._q_params = prepared.q_params
            self._q_scales = prepared.q_scales
            self.quant_report = prepared.quant_report
        if self._prefix_cache is not None:
            self._prefix_cache.clear()

    # ----- prefix cache ---

    def set_prefix_cache(self, cache) -> None:
        """Attach a ``PrefixCache``, consulted by ``begin_prefill`` and
        fed at every chunk boundary by ``advance_prefill``."""
        self._prefix_cache = cache

    @property
    def prefix_cache(self):
        return self._prefix_cache

    # ----- slot lifecycle ---

    @property
    def num_active(self) -> int:
        return self.max_slots - len(self._free)

    def acquire(self) -> Optional[int]:
        """Claim the lowest free slot, or None when the pool is full."""
        if not self._free:
            return None
        self._free.sort()
        return self._free.pop(0)

    @torch.inference_mode()
    def release(self, slot: int) -> None:
        """Return a finished or cancelled slot to the free list. Its
        device state is not scrubbed (the next admission rewrites it); a
        slot still decoding is stopped."""
        if slot in self._free:
            return
        if self._live[slot]:
            self.slots.live[slot] = False
            self._live[slot] = False
        self._free.append(slot)

    # ----- admission ---

    def validate(self, prime, length, *, add_bos: bool = False,
                 temperature: float = 1.0, top_p=None, top_k=25,
                 template=None, frozen=None) -> None:
        """Raise ValueError for anything the pool cannot serve: the
        standalone decoder's checks, the pool's max_len and the dynamic
        sampler's top_k range. No device work."""
        if length > self.max_len:
            raise ValueError(
                f"length {length} exceeds engine max_len {self.max_len}"
            )
        _validate_knobs(temperature, top_p)
        num_tokens = self.model.config.num_tokens
        if top_k is not None and not 1 <= int(top_k) <= num_tokens:
            raise ValueError(
                f"top_k must be None or in [1, {num_tokens}], got {top_k}"
            )
        _validate_infill(template, frozen, length, num_tokens)
        _prepare_seq(self.model.config, prime, length, add_bos)

    def _pending(self, slot, prime, length, *, top_k, add_bos, temperature,
                 top_p, seed, draw_offset, request_id, template,
                 frozen) -> PendingPrefill:
        """The admission's operands, built alike for the monolithic and
        the chunked path, with a fresh batch-1 cache at depth 0."""
        self.validate(prime, length, add_bos=add_bos,
                      temperature=temperature, top_p=top_p, top_k=top_k,
                      template=template, frozen=frozen)
        seq, start = _prepare_seq(self.model.config, prime, length, add_bos)
        row = np.zeros((self.max_len,), np.int64)
        row[:seq.shape[0]] = seq
        trow = np.zeros((self.max_len,), np.int64)
        frow = np.zeros((self.max_len,), bool)
        if template is not None:
            trow[:length] = np.asarray(template, np.int64).reshape(-1)
            frow[:length] = np.asarray(frozen, bool).reshape(-1)
        return PendingPrefill(
            slot=int(slot), row=row,
            tokens=torch.from_numpy(row).to(self.device), start=int(start),
            length=int(length), seed=int(seed),
            draw_offset=int(draw_offset), temperature=float(temperature),
            top_p_val=float(_TOP_P_OFF if top_p is None else top_p),
            top_k_val=int(0 if top_k is None else top_k),
            parity=temperature == 1.0 and top_p is None, trow=trow,
            frow=frow, cache=self.fresh_cache.clone(),
            request_id="" if request_id is None else str(request_id),
        )

    def _feed(self, pending: PendingPrefill, hi: int) -> None:
        """Feed prime positions ``pending.pos..hi-1`` through the pending
        batch-1 cache, one token a step, as ``sample_fast`` primes."""
        step = self._decoder()
        for p in range(pending.pos, hi):
            step(pending.tokens[p:p + 1], pending.cache)
        pending.pos = hi

    def _scatter(self, pending: PendingPrefill) -> None:
        """Copy a primed batch-1 cache and the request's state into its
        slot and mark the slot live: the only point an admission touches
        the pool."""
        sl, s = self.slots, pending.slot
        sl.cache.set_row_(s, pending.cache)
        sl.seqs[s] = pending.tokens
        sl.cur[s] = pending.start - 1
        # zeros in the primed region count toward the stop-at-second-zero
        # rule, as the standalone decoder's truncation counts them
        sl.nz[s] = int((pending.row[:pending.start] == 0).sum())
        sl.target[s] = pending.length
        sl.temp[s] = pending.temperature
        sl.top_p[s] = pending.top_p_val
        sl.top_k[s] = pending.top_k_val
        sl.parity[s] = pending.parity
        sl.template[s] = torch.from_numpy(pending.trow)
        sl.frozen[s] = torch.from_numpy(pending.frow)
        sl.live[s] = True
        sl.seed[s], sl.draws[s] = pending.seed, pending.draw_offset
        self._live[s] = True
        self._cur[s] = pending.start - 1
        self._targets[s] = pending.length

    @torch.inference_mode()
    def prefill(self, slot: int, prime, length: int, *, top_k=25,
                add_bos: bool = False, temperature: float = 1.0,
                top_p=None, seed: int = 0, draw_offset: int = 0,
                request_id: Optional[str] = None, template=None,
                frozen=None) -> int:
        """Admit a request into ``slot`` at once: feed its prime through a
        fresh batch-1 cache, then copy that into the slot (an admission
        in one chunk, without a prefix-cache lookup). Returns the primed
        positions (``start``). The slot's stream is
        ``sample_fast(seed, model, prime, length, ...)``'s from draw
        ``draw_offset`` on. ``template``/``frozen`` ((length,) arrays)
        make it an infill. ``request_id`` labels the spans only."""
        with span("serve/prefill", slot=int(slot),
                  request_id="" if request_id is None else str(request_id)):
            pending = self._pending(
                slot, prime, length, top_k=top_k, add_bos=add_bos,
                temperature=temperature, top_p=top_p, seed=seed,
                draw_offset=draw_offset, request_id=request_id,
                template=template, frozen=frozen)
            self.advance_prefill(pending)
        return pending.start

    @torch.inference_mode()
    def begin_prefill(self, slot: int, prime, length: int, *, top_k=25,
                      add_bos: bool = False, temperature: float = 1.0,
                      top_p=None, seed: int = 0, draw_offset: int = 0,
                      request_id: Optional[str] = None, template=None,
                      frozen=None) -> PendingPrefill:
        """Start a chunked admission into ``slot``: the operands of
        ``prefill`` and no model work yet; ``advance_prefill`` feeds it
        between decode steps. With a prefix cache attached, the deepest
        cached prefix of the feed region seeds it at that depth. The
        stream equals ``prefill``'s with the same arguments. The
        ``serve/prefill`` span marks the admission's start."""
        with span("serve/prefill", slot=int(slot),
                  request_id="" if request_id is None else str(request_id)):
            pending = self._pending(
                slot, prime, length, top_k=top_k, add_bos=add_bos,
                temperature=temperature, top_p=top_p, seed=seed,
                draw_offset=draw_offset, request_id=request_id,
                template=template, frozen=frozen)
            if self._prefix_cache is not None:
                depth, snap = self._prefix_cache.lookup(pending.row,
                                                        pending.feed_len)
                if snap is not None:
                    pending.cache = snap
                    pending.pos = pending.hit_depth = int(depth)
        return pending

    @torch.inference_mode()
    def advance_prefill(self, pending: PendingPrefill,
                        budget: Optional[int] = None) -> bool:
        """Feed up to ``budget`` more prime positions (all that remain
        when None), snapshot the chunk boundary into the prefix cache,
        and once the feed region is done copy the slot into the pool.
        Returns True once the slot is live."""
        if pending.done:
            return True
        feed_len = pending.feed_len
        hi = feed_len if budget is None else min(
            feed_len, pending.pos + max(int(budget), 0))
        with span("serve/prefill_chunk", slot=int(pending.slot),
                  request_id=pending.request_id, lo=int(pending.pos),
                  hi=int(hi)):
            if hi > pending.pos:
                self._feed(pending, hi)
                if self._prefix_cache is not None:
                    self._prefix_cache.insert(pending.row, pending.pos,
                                              pending.cache)
            if pending.pos >= feed_len:
                self._scatter(pending)
                pending.done = True
        return pending.done

    # ----- the hot loop ---

    @torch.inference_mode()
    def decode_step(self):
        """One token for every live slot. Returns host arrays (sampled,
        was_live, finished), each (max_slots,): ``sampled[i]`` means
        something only where ``was_live[i]``; ``finished`` marks the
        slots that drew their second zero or reached their length."""
        sl = self.slots
        last = sl.seqs.shape[1] - 1
        live = sl.live.clone()
        toks = sl.seqs[self._rows, sl.cur.clamp(0, last)]
        # a dead slot decodes at position 0; its row is reset on admission
        sl.cache.place_(torch.where(live, sl.cur, 0), top=max(
            (c for c, on in zip(self._cur, self._live) if on), default=0))
        logits = self._decoder()(toks, sl.cache)
        noise = seeded_noise(
            [s if on else None for s, on in zip(sl.seed, self._live)],
            sl.draws, logits.shape[-1]).to(self.device)
        sampled = gumbel_step_dynamic(noise, logits, sl.top_k, sl.parity,
                                      sl.temp, sl.top_p)
        wpos = (sl.cur + 1).clamp(0, last)
        # infill, as sample_fast constrains it; a slot whose mask freezes
        # nothing keeps its draw
        sampled = _constrain(sampled, logits, wpos, sl.template, sl.frozen)
        sl.seqs[self._rows, wpos] = torch.where(
            live, sampled, sl.seqs[self._rows, wpos])
        sl.nz += (sampled == 0) & live
        sl.cur += live
        finished = live & ((sl.nz >= 2) | (sl.cur >= sl.target - 1))
        sl.live &= ~finished
        out = torch.stack([sampled, live, finished]).cpu().numpy()
        sampled, was_live, finished = out[0], out[1] != 0, out[2] != 0
        for s in np.flatnonzero(was_live):
            sl.draws[s] += 1
            self._cur[s] += 1
            self._live[s] = not finished[s]
        return sampled, was_live, finished

    def collect(self, slot: int) -> np.ndarray:
        """The finished request's (target,) token buffer, everything after
        the second zero set to 0 as the standalone decoder does, so it
        compares token for token with ``sample_fast``."""
        row = self.slots.seqs[slot, :self._targets[slot]].cpu().numpy()
        row = row.copy()
        row[np.cumsum(row == 0) > 1] = 0
        return row

    # ----- embeddings ---

    def embed(self, prime, *, add_bos: bool = False) -> np.ndarray:
        """The final-norm mean-pooled representation of ``prime``
        (``workloads/embeddings.py``): one full forward, through the
        kernels on the card. Lengths are bucketed to powers of two; a
        gMLP model pads to its seq_len (its SGU matrix takes nothing
        narrower). Returns (dim,) float32."""
        prime = np.asarray(prime, np.int64).reshape(-1)
        if add_bos:
            prime = np.concatenate([np.zeros((1,), np.int64), prime])
        if prime.shape[0] == 0:
            raise ValueError("empty prime requires add_bos=True")
        cfg = self.model.config
        n = bucket_length(int(prime.shape[0]), cfg.seq_len,
                          minimum=max(8, cfg.window_size),
                          fixed=cfg.global_mlp_depth > 0)
        row = torch.zeros((1, n), dtype=torch.int64, device=self.device)
        row[0, :prime.shape[0]] = torch.from_numpy(prime)
        with span("serve/embed", n_tokens=int(prime.shape[0])):
            out = embed_step(self.model, row)
        return out[0].cpu().numpy()

"""Autoregressive sampling with the KV-cache decoder: top-k Gumbel-max.

Same semantics as the JAX package's ``sample_fast``:

* a fixed-shape (length,) buffer per row; the prime is fed one token per
  step to fill the cache, then every step draws one token;
* Gumbel-max top-k with the reference sampler's quirk on the default
  knobs: tokens outside the top k get logit 0 and noise 0, and still
  compete in the argmax at value 0. With ``top_k = 1`` the strict ``>``
  masks every token, so the draw is token 0 (EOS). Temperature and top-p
  instead mask with the dtype's minimum;
* ``add_bos`` shifts the prime right by one;
* everything after the second zero token is zeroed afterwards (BOS is
  the first zero, the emitted EOS the second).

RNG rule. Torch cannot reproduce JAX's threefry streams, so the port has
its own: row i of ``sample_fast_batched(seed, ...)`` equals
``sample_fast(row_seed(seed, i), ...)`` on that prime, and draw t of a
row is a function of that row's seed and t alone (a CPU
``torch.Generator`` seeded with ``draw_seed(row_seed, t)``). A replay can
therefore resume a stream at any draw. The noise is drawn and
transformed on the CPU whatever device the model is on, and copied to
the logits' device once a step, so a seed gives the same noise on the
CPU and on the card (the card's own generator, Philox, would give other
numbers than the CPU's Mersenne Twister). ``noise=`` replaces the draws
(tests hand in the JAX package's noise through it).

``gumbel_step_dynamic`` is the serving engine's sampler: every knob a
per-row tensor, both branches computed and then selected per row, equal
token for token to ``gumbel_topk_step`` with that row's knobs.
``template``/``frozen`` (``sample_fast``) constrain a decode to
fixed-position infilling (``_constrain``).

``sample`` and ``sample_batched`` are the naive decoders, the JAX
package's functions of those names: one full forward (through the
kernels on the card) per drawn token instead of the cache. They take the
same draws, so with the same seed they give ``sample_fast``'s tokens
wherever the two forwards' logits pick the same token.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from progen_tpu_torch._device import resolve_device

EPS = 1e-20
_TOP_P_OFF = 2.0  # select_top_p keep-all sentinel
_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def row_seed(seed: int, i: int) -> int:
    """The seed of row i of a batched decode seeded with ``seed``."""
    return _mix64(_mix64(int(seed) & _M64) ^ int(i)) >> 1


def draw_seed(seed: int, t: int) -> int:
    """The generator seed of draw t of a row seeded with ``seed``."""
    return _mix64(_mix64((int(seed) & _M64) ^ 0x5851F42D4C957F2D)
                  ^ int(t)) >> 1


def gumbel_noise(gen: torch.Generator, shape) -> torch.Tensor:
    """float32 Gumbel noise from the CPU generator ``gen``, on the CPU."""
    u = torch.rand(shape, generator=gen)
    return -torch.log(-torch.log(u + EPS) + EPS)


def select_top_k(logits: torch.Tensor, k: int):
    """(mask, masked_logits): keep entries strictly above the k-th
    largest value, zero the rest."""
    values = torch.topk(logits, k, dim=-1).values
    mask = logits > values.amin(dim=-1, keepdim=True)
    return mask, torch.where(mask, logits, torch.zeros_like(logits))


def select_top_p(logits: torch.Tensor, p) -> torch.Tensor:
    """Nucleus mask: the smallest set of highest-probability tokens whose
    cumulative mass reaches ``p`` (the crossing token included)."""
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sort_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    inv = torch.argsort(sort_idx, dim=-1, stable=True)
    return torch.gather(keep_sorted, -1, inv)


def gumbel_topk_step(logit: torch.Tensor, top_k: Optional[int],
                     noise: torch.Tensor, parity: bool = True,
                     temperature: float = 1.0,
                     top_p: float = _TOP_P_OFF) -> torch.Tensor:
    """One Gumbel-max draw over the last axis with the given noise.
    ``parity`` (the default knobs) keeps the reference quirk: filtered
    tokens compete at value 0."""
    if parity:
        if top_k is not None:
            mask, logit = select_top_k(logit, top_k)
            noise = noise * mask
        return torch.argmax(logit + noise, dim=-1)
    logit = logit / temperature
    mask = select_top_p(logit, top_p)
    if top_k is not None:
        mask = mask & select_top_k(logit, top_k)[0]
    logit = torch.where(mask, logit,
                        torch.full_like(logit, torch.finfo(logit.dtype).min))
    return torch.argmax(logit + noise, dim=-1)


def _validate_knobs(temperature, top_p):
    try:
        t = float(temperature)
    except (TypeError, ValueError):
        t = float("nan")
    if not (math.isfinite(t) and t > 0.0):
        raise ValueError(
            f"temperature must be a positive finite float, got {temperature}"
        )
    if top_p is not None and not 0.0 < float(top_p) <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def _prepare_seq(config, prime, length: int, add_bos: bool):
    """The fixed-shape decode buffer (BOS shift, right padding) and the
    first position to fill. ``prime`` is (prime_len,) or
    (batch, prime_len)."""
    if length > config.seq_len:
        raise ValueError(
            f"length {length} exceeds the model's seq_len {config.seq_len} "
            "(RoPE tables and the SGU spatial matrix are bound to seq_len)"
        )
    prime = np.asarray(prime, np.int64)
    start = prime.shape[-1] + (1 if add_bos else 0)
    if start == 0:
        raise ValueError("empty prime requires add_bos=True")
    if start >= length:
        raise ValueError(f"prime length {start} must be < length {length}")
    pad = ((1, length - prime.shape[-1] - 1) if add_bos
           else (0, length - prime.shape[-1]))
    widths = ((0, 0),) * (prime.ndim - 1) + (pad,)
    return np.pad(prime, widths), start


def seeded_noise(seeds, draws, vocab: int) -> torch.Tensor:
    """(rows, vocab) float32 Gumbel noise on the CPU: row i is draw
    ``draws[i]`` of the stream seeded with ``seeds[i]``, from a CPU
    generator seeded with ``draw_seed(seeds[i], draws[i])``. A row whose
    seed is None is zeros (a slot with nothing to draw)."""
    gen = torch.Generator()  # the CPU's, on every device
    rows = []
    for s, t in zip(seeds, draws, strict=True):
        if s is None:
            rows.append(torch.zeros(vocab))
            continue
        gen.manual_seed(draw_seed(s, t))
        rows.append(gumbel_noise(gen, (vocab,)))
    return torch.stack(rows)


def _seeded_draws(row_seeds) -> Callable:
    """draw(t, logit): draw t of every row, (rows, vocab), on logit's
    device, drawn on the CPU whatever that device is."""
    def draw(t: int, logit: torch.Tensor) -> torch.Tensor:
        return seeded_noise(row_seeds, [t] * len(row_seeds),
                            logit.shape[-1]).to(logit.device)

    return draw


def gumbel_step_dynamic(noise: torch.Tensor, logit: torch.Tensor,
                        top_k: torch.Tensor, parity: torch.Tensor,
                        temperature: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """One Gumbel-max draw per row with every knob a (rows,) tensor:
    ``top_k`` int (0 = off), ``parity`` bool, ``temperature`` and
    ``top_p`` float32 (``_TOP_P_OFF`` = off). Both branches are computed,
    then selected per row. Equal to ``gumbel_topk_step`` with each row's
    knobs: the k-th value of a descending sort is ``topk``'s minimum, and
    the knob branch takes its threshold from the tempered logits, as
    ``select_top_k`` does."""
    kc = (top_k.clamp(1, logit.shape[-1]) - 1)[:, None]
    k_off = (top_k <= 0)[:, None]

    def kth(x):
        return torch.sort(x, dim=-1, descending=True).values.gather(-1, kc)

    # the parity branch, with the reference's quirk: filtered tokens
    # compete at 0
    keep = (logit > kth(logit)) | k_off
    pick_parity = torch.argmax(torch.where(keep, logit, 0.0)
                               + torch.where(keep, noise, 0.0), dim=-1)
    lt = logit / temperature[:, None]
    keep = select_top_p(lt, top_p[:, None]) & ((lt > kth(lt)) | k_off)
    pick_knobs = torch.argmax(
        torch.where(keep, lt, torch.finfo(lt.dtype).min) + noise, dim=-1)
    return torch.where(parity, pick_parity, pick_knobs)


def _validate_infill(template, frozen, length: int, num_tokens: int):
    """(template, frozen) as (length,) int64 and bool numpy arrays, or
    (None, None) when infilling is off. ``template`` pins token ids at
    the positions where ``frozen`` is True."""
    if (template is None) != (frozen is None):
        raise ValueError("template and frozen must be given together")
    if template is None:
        return None, None
    t = np.asarray(template, np.int64).reshape(-1)
    f = np.asarray(frozen, bool).reshape(-1)
    if t.shape[0] != length or f.shape[0] != length:
        raise ValueError(
            f"template/frozen must be (length={length},) arrays, got "
            f"{t.shape} / {f.shape}"
        )
    if (t < 0).any() or (t >= num_tokens).any():
        raise ValueError(f"template token ids must be in [0, {num_tokens})")
    if ((t == 0) & f).any():
        raise ValueError(
            "frozen positions must pin a nonzero token id (0 is the "
            "BOS/EOS/pad token: freezing it would end the sequence)"
        )
    return t, f


def _constrain(sampled, logit, pos, template, frozen):
    """The infill mask on one draw per row, written at positions ``pos``
    (rows,): a frozen position takes the template token; at a free one a
    drawn EOS (0) becomes the best non-EOS token, since an infill has a
    fixed extent. A row whose mask freezes nothing keeps its draw."""
    alt = torch.argmax(logit[:, 1:], dim=-1) + 1
    sampled = torch.where(frozen.any(dim=-1) & (sampled == 0), alt, sampled)
    at = pos[:, None]
    return torch.where(frozen.gather(-1, at)[:, 0],
                       template.gather(-1, at)[:, 0], sampled)


@torch.inference_mode()
def _decode_batched(model, seqs: torch.Tensor, start: int, length: int,
                    top_k, parity, temperature, top_p, draw,
                    infill=None) -> torch.Tensor:
    """seqs (B, length) primed up to ``start``; fills the rest in place.
    ``infill``: (template, frozen), each (B, length), or None."""
    cache = model.init_cache(seqs.shape[0])
    for p in range(start - 1):  # prefill by feeding the prime
        model.decode_step(seqs[:, p], cache)
    for t, p in enumerate(range(start - 1, length - 1)):
        logit = model.decode_step(seqs[:, p], cache)
        seqs[:, p + 1] = _draw(logit, top_k, draw(t, logit), parity,
                               temperature, top_p, p + 1, infill)
    return _truncate_after_eos(seqs)


def _draw(logit, top_k, noise, parity, temperature, top_p, p, infill):
    """One draw per row for write position ``p``, constrained when
    ``infill`` is given."""
    sampled = gumbel_topk_step(logit, top_k, noise, parity, temperature,
                               top_p)
    if infill is None:
        return sampled
    pos = torch.full_like(sampled, p)
    return _constrain(sampled, logit, pos, *infill)


@torch.inference_mode()
def _decode_naive(model, seqs: torch.Tensor, start: int, length: int,
                  top_k, parity, temperature, top_p, draw,
                  infill=None) -> torch.Tensor:
    """As ``_decode_batched``, with one full forward per draw. The
    buffer is padded to the model's seq_len, which the forward needs; the
    model is causal, so the padding changes no logit before it."""
    buf = torch.zeros(seqs.shape[0], model.config.seq_len,
                      dtype=seqs.dtype, device=seqs.device)
    buf[:, :length] = seqs
    for t, p in enumerate(range(start - 1, length - 1)):
        logit = model(buf)[:, p]
        buf[:, p + 1] = _draw(logit, top_k, draw(t, logit), parity,
                              temperature, top_p, p + 1, infill)
    return _truncate_after_eos(buf[:, :length])


def _truncate_after_eos(seqs: torch.Tensor) -> torch.Tensor:
    """Zero everything after the second zero token."""
    after_eos = torch.cumsum((seqs == 0).long(), dim=-1) > 1
    return seqs * (~after_eos)


def _sample(row_seeds, model, primes, length, top_k, add_bos, temperature,
            top_p, device, noise, decode=_decode_batched, template=None,
            frozen=None):
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, not {dev}")
    _validate_knobs(temperature, top_p)
    parity = temperature == 1.0 and top_p is None
    seqs, start = _prepare_seq(model.config, primes, length, add_bos)
    seqs = torch.from_numpy(seqs).to(dev)
    template, frozen = _validate_infill(template, frozen, length,
                                        model.config.num_tokens)
    infill = None if template is None else tuple(
        torch.from_numpy(a).to(dev).expand(seqs.shape[0], -1)
        for a in (template, frozen))
    if noise is None:
        draw = _seeded_draws(row_seeds)
    else:
        def draw(t, logit):
            return torch.as_tensor(noise(t), dtype=logit.dtype,
                                   device=dev).reshape(logit.shape)
    return decode(
        model, seqs, start, length, top_k, parity, float(temperature),
        _TOP_P_OFF if top_p is None else float(top_p), draw, infill,
    )


def _batched_seeds(seed: int, primes):
    """(primes as a (batch, prime_len) array, each row's seed)."""
    primes = np.asarray(primes)
    if primes.ndim != 2 or primes.shape[0] == 0:
        raise ValueError(
            f"primes must be (batch >= 1, prime_len), got {primes.shape}"
        )
    return primes, [row_seed(seed, i) for i in range(primes.shape[0])]


def sample_fast(seed: int, model, prime, length: int,
                top_k: Optional[int] = 25, add_bos: bool = False,
                temperature: float = 1.0, top_p: Optional[float] = None,
                template=None, frozen=None, *, device="cuda",
                noise: Optional[Callable] = None):
    """KV-cache decode of one (length,) sequence continuing ``prime``.
    ``template``/``frozen`` ((length,) arrays in buffer coordinates,
    ``workloads/infill.py``) make it an infill: frozen positions emit the
    template's token. ``noise(t)``, when given, returns draw t's
    (num_tokens,) Gumbel noise in place of the seeded draws."""
    prime = np.asarray(prime)
    if prime.ndim != 1:
        raise ValueError(f"prime must be 1-D, got shape {prime.shape}")
    return _sample([seed], model, prime[None], length, top_k, add_bos,
                   temperature, top_p, device, noise, template=template,
                   frozen=frozen)[0]


def sample_fast_batched(seed: int, model, primes, length: int,
                        top_k: Optional[int] = 25, add_bos: bool = False,
                        temperature: float = 1.0,
                        top_p: Optional[float] = None, *, device="cuda",
                        noise: Optional[Callable] = None):
    """Batched KV-cache decode: primes (batch, prime_len) ->
    (batch, length). Row i equals ``sample_fast(row_seed(seed, i), ...)``
    on that prime. ``noise(t)`` returns draw t's (batch, num_tokens)
    noise."""
    primes, seeds = _batched_seeds(seed, primes)
    return _sample(seeds, model, primes, length, top_k, add_bos,
                   temperature, top_p, device, noise)


def sample(seed: int, model, prime, length: int,
           top_k: Optional[int] = 25, add_bos: bool = False,
           temperature: float = 1.0, top_p: Optional[float] = None,
           template=None, frozen=None, *, device="cuda",
           noise: Optional[Callable] = None):
    """``sample_fast`` by one full forward per drawn token."""
    prime = np.asarray(prime)
    if prime.ndim != 1:
        raise ValueError(f"prime must be 1-D, got shape {prime.shape}")
    return _sample([seed], model, prime[None], length, top_k, add_bos,
                   temperature, top_p, device, noise, _decode_naive,
                   template=template, frozen=frozen)[0]


def sample_batched(seed: int, model, primes, length: int,
                   top_k: Optional[int] = 25, add_bos: bool = False,
                   temperature: float = 1.0, top_p: Optional[float] = None,
                   *, device="cuda", noise: Optional[Callable] = None):
    """``sample_fast_batched`` by one full forward per drawn token."""
    primes, seeds = _batched_seeds(seed, primes)
    return _sample(seeds, model, primes, length, top_k, add_bos,
                   temperature, top_p, device, noise, _decode_naive)

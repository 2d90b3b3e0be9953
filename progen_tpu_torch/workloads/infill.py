"""Fixed-position infilling: template strings -> sampler constraint arrays.

The port's copy of the JAX package's ``workloads/infill.py``. A template
is a protein string with free positions marked by a sentinel character
(default ``?``): ``MK?LV??G`` freezes M, K, L, V and G at their positions
and samples the three ``?`` slots. The sampler (``sampling.py``,
``_constrain``) takes the pair (template tokens, frozen mask) aligned to
the decode buffer, where index 0 is the BOS column when ``add_bos`` is
set; this module translates a string into that pair for the serving
protocol (``cli/serve.py`` template requests).

The longest frozen prefix becomes the prime: its tokens are forced
anyway, so feeding them as the prime skips that many draws and puts the
first sampled position next to real context.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from progen_tpu_torch.data.tokenizer import encode_tokens


def parse_template(
    template: str, free_char: str = "?"
) -> Tuple[List[int], List[bool]]:
    """Template string -> (token ids with 0 at free positions, frozen
    mask). Tokens follow the byte tokenizer (ord + 1), so frozen
    positions round-trip exactly through ``decode_tokens``."""
    if len(free_char) != 1:
        raise ValueError(f"free_char must be one character, got {free_char!r}")
    if not template:
        raise ValueError("empty template")
    frozen = [c != free_char for c in template]
    if all(frozen):
        raise ValueError(
            f"template has no free ({free_char!r}) positions: nothing to "
            "infill; score it instead"
        )
    toks = encode_tokens(template.replace(free_char, "\x00"))
    # chr(0) encodes to id 1; free positions carry 0 (never emitted frozen)
    tokens = [0 if not f else int(t) for t, f in zip(toks, frozen)]
    return tokens, frozen


def infill_request_arrays(
    tokens: List[int], frozen: List[bool], add_bos: bool = True
) -> Tuple[np.ndarray, int, np.ndarray, np.ndarray]:
    """(prime, length, template, frozen) for ``sample_fast`` and the serve
    protocol: the leading frozen run is hoisted into the prime, and the
    constraint arrays are shifted to buffer coordinates (a BOS column at
    index 0 when ``add_bos``)."""
    if len(tokens) != len(frozen):
        raise ValueError("tokens and frozen must be the same length")
    k = 0
    while k < len(frozen) and frozen[k]:
        k += 1
    if k == 0 and not add_bos:
        raise ValueError(
            "template starts at a free position and add_bos is off: the "
            "decoder needs at least one prime token (pass add_bos=True)"
        )
    off = 1 if add_bos else 0
    length = len(tokens) + off
    tpl = np.zeros((length,), np.int32)
    frz = np.zeros((length,), bool)
    tpl[off:] = tokens
    frz[off:] = frozen
    prime = np.asarray(tokens[:k], np.int32)
    return prime, length, tpl, frz

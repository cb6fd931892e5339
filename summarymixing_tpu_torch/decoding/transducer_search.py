"""Transducer greedy decoding — the port of `transducer_greedy_decode` from
`summarymixing_tpu/decoding/transducer_search.py` (its beam search with
RNNLM fusion is still to port, ROADMAP.md).

All rows advance together: every encoder frame runs a fixed
`max_symbols_per_frame` emit steps, and per-row `torch.where` selects
decide which rows take the emitted token and the predictor's new state,
as the JAX `lax.scan`/`fori_loop` does. Nothing is read to the host inside
the loop. The argmax takes the lowest index among equal logits, as
`jnp.argmax` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

MAX_SYMBOLS_PER_FRAME = 3   # emit steps per encoder frame (the recipes' greedy and streaming)


def transducer_greedy_decode(enc_proj: torch.Tensor, enc_lengths: torch.Tensor,
                             predictor_init: Callable, predictor_step: Callable,
                             joint_step: Callable, blank_id: int = 0,
                             max_symbols_per_frame: int = MAX_SYMBOLS_PER_FRAME,
                             max_tokens: Optional[int] = None,
                             carry: Optional[tuple] = None, return_carry: bool = False):
    """enc_proj `[B, T, J]` (after `proj_enc`), enc_lengths `[B]` -> (tokens
    `[B, Umax]`, lengths `[B]`).

    Streaming: pass the previous chunk's `carry` (from `return_carry=True`)
    with the next chunk's enc_proj and valid lengths; tokens and lengths
    accumulate across chunks. The token buffer is made on the first chunk
    and cannot grow, so a first call with `return_carry=True` must give
    `max_tokens` sized for the whole stream (it raises `ValueError`
    otherwise)."""
    b, t, _ = enc_proj.shape
    device = enc_proj.device
    if return_carry and carry is None and max_tokens is None:
        raise ValueError("streaming decode (return_carry=True) requires max_tokens sized "
                         "for the whole stream — the carried token buffer cannot grow "
                         "past the first chunk's default")
    if carry is not None:
        pred_state, dec_proj, tokens, lens = carry
        umax = tokens.shape[1]
    else:
        umax = max_tokens or t * 2
        pred_state, dec_proj = predictor_step(
            predictor_init(b), torch.full((b,), blank_id, dtype=torch.long, device=device))
        tokens = torch.zeros(b, umax, dtype=torch.long, device=device)
        lens = torch.zeros(b, dtype=torch.long, device=device)
    slots = torch.arange(umax, device=device)[None, :]
    in_frame = torch.arange(t, device=device)[:, None] < enc_lengths.to(device)[None, :]  # [T, B]
    for ti in range(t):
        enc_frame = enc_proj[:, ti]
        active = in_frame[ti]
        for _ in range(max_symbols_per_frame):
            k = joint_step(enc_frame, dec_proj).argmax(dim=-1)
            emit = active & (k != blank_id) & (lens < umax)
            tokens = torch.where(emit[:, None] & (slots == lens[:, None]), k[:, None], tokens)
            new_state, new_proj = predictor_step(pred_state, k)
            pred_state = tuple(torch.where(emit[:, None], new, old)
                               for new, old in zip(new_state, pred_state))
            dec_proj = torch.where(emit[:, None], new_proj, dec_proj)
            lens = lens + emit.long()
            active = emit
    if return_carry:
        return tokens, lens, (pred_state, dec_proj, tokens, lens)
    return tokens, lens

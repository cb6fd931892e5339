"""Joint CTC/attention beam search with LM shallow fusion — the port of
`summarymixing_tpu/decoding/s2s_beam.py`.

    score(h) = (1 - ctc_w) · att(h) + ctc_w · ctc_prefix(h) + lm_w · lm(h)

with partial CTC scoring: each step, the top 2·beam tokens by the
attention (+ LM) score are CTC-scored, the rest pruned. The hypotheses are fixed-width `[B, beam]` tensors with a
finished mask: at the start only beam 0 of each utterance is live (the
others sit at -1e9); a finished row extends only with eos at delta 0 and
keeps competing on its frozen score. Final scores are divided by
`len + 1` (eos counts).

Where the JAX search runs inside `jit`, this one is an eager loop. Two
consequences:

- the early exit (every row finished) is a host read of one flag per
  step, so the loop stops at the step the JAX `while_loop` stops at;
- every top-k is a stable descending sort cut to k, which puts the lower
  index first among equal scores, as `jax.lax.top_k` does (ties are
  common here: the dead initial beams, finished rows' candidates).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from summarymixing_tpu_torch.decoding.ctc_prefix import (
    CTCPrefixState,
    ctc_prefix_advance,
    ctc_prefix_init,
    ctc_prefix_score,
    ctc_prefix_score_only,
    ctc_prefix_select,
)

_NEG = -1e9


@dataclass(frozen=True)
class S2SBeamConfig:
    beam_size: int = 10
    ctc_weight: float = 0.4
    lm_weight: float = 0.0
    blank_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    max_length: int = 128     # decode-length cap
    # decoder-softmax temperature, a re-normalised log-softmax of the
    # decoder's log-probs / temperature (= softmax(logits / temperature))
    temperature: float = 1.0
    # score candidates without their [N, K, T] prefix states and rebuild
    # the chosen ones' after pruning (exact); False keeps the
    # materialise-then-select path as the oracle
    ctc_defer_states: bool = True


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, lower index first among equals
    (`jax.lax.top_k`'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_rows(tree, spare, parent: torch.Tensor, n: int):
    """The leaves of `tree` with `n` rows gathered by `parent`, written into
    the matching leaves of `spare` (new buffers when it is None); other
    leaves pass through. Returns `(gathered, tree)`: the old leaves are the
    next call's buffers, so the caches live in two copies, whoever else
    holds the first."""
    if isinstance(tree, dict):
        pairs = {k: _gather_rows(v, None if spare is None else spare[k], parent, n)
                 for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    if isinstance(tree, (list, tuple)):
        pairs = [_gather_rows(v, None if spare is None else spare[i], parent, n)
                 for i, v in enumerate(tree)]
        return type(tree)(p[0] for p in pairs), type(tree)(p[1] for p in pairs)
    if tree.shape[0] != n:
        return tree, None
    if spare is None:
        return tree.index_select(0, parent), tree
    return torch.index_select(tree, 0, parent, out=spare), tree


def s2s_beam_search(decode_step_fn: Callable, enc_out: Optional[torch.Tensor],
                    enc_lengths: torch.Tensor, ctc_log_probs: Optional[torch.Tensor],
                    config: S2SBeamConfig, lm_step_fn: Optional[Callable] = None,
                    cache=None, lm_cache=None, nbest: int = 1):
    """Run the search over B utterances, N = B·beam hypothesis rows.

    - `decode_step_fn(tokens [N, L+1], step) -> [N, V]` log-probs from the
      whole prefix `tokens[:, :step+1]`; or, with `cache`,
      `decode_step_fn(last_tokens [N], step, cache) -> ([N, V], cache)`.
    - `enc_out` is not read (the encoder state lives in the step function);
      `enc_lengths` is the CTC scorer's length vector, beam-tiled `[N]`.
    - `ctc_log_probs`: per-utterance `[B, T, V]` (a pre-tiled `[N, T, V]`
      is folded back); the scorer maps row n to utterance n // beam.
    - `lm_step_fn(tokens, step) -> [N, V]`, or with `lm_cache`
      `lm_step_fn(last_tokens, step, lm_cache) -> ([N, V], lm_cache)`.

    After each step's pruning, the cache leaves with N rows are gathered
    by the parent rows; the others (the cross-attention K/V at B rows)
    are left as they are. The search takes the caches over: it writes
    into them and uses them as gather buffers, as the JAX search's
    `while_loop` consumes its carry.

    Returns `(best_tokens [B, max_length], best_lengths [B], best_scores
    [B])`, tokens without bos and eos; with `nbest` > 1 the top
    min(nbest, beam) per utterance, score-sorted: `[B, n, max_length]`,
    `[B, n]`, `[B, n]`."""
    beam = config.beam_size
    n = enc_lengths.shape[0]
    batch = n // beam
    lmax = config.max_length
    dev = enc_lengths.device
    use_ctc = config.ctc_weight > 0.0 and ctc_log_probs is not None
    k_ctc = 2 * beam
    if ctc_log_probs is not None:
        k_ctc = min(k_ctc, ctc_log_probs.shape[-1])
    att_w = 1.0 - config.ctc_weight

    tokens = torch.full((n, lmax + 1), config.eos_id, dtype=torch.int64, device=dev)
    tokens[:, 0] = config.bos_id
    rows = torch.arange(n, device=dev)
    scores = torch.where(rows % beam == 0, 0.0, _NEG).to(torch.float32)
    lengths = torch.zeros((n,), dtype=torch.int64, device=dev)
    finished = torch.zeros((n,), dtype=torch.bool, device=dev)
    ctc_state = None
    if use_ctc:
        if ctc_log_probs.shape[0] == n and beam > 1:
            ctc_log_probs = ctc_log_probs[::beam]
        ctc_state = ctc_prefix_init(ctc_log_probs, enc_lengths, config.blank_id, beam=beam)
    utt_base = (torch.arange(batch, device=dev) * beam)[:, None]
    cache_spare = lm_spare = None

    step = 0
    while step < lmax and not bool(finished.all()):
        if cache is not None:
            att_lp, cache = decode_step_fn(tokens[:, step], step, cache)
        else:
            att_lp = decode_step_fn(tokens, step)
        v = att_lp.shape[-1]
        k = min(k_ctc, v)
        if config.temperature != 1.0:
            att_lp = torch.log_softmax(att_lp / config.temperature, dim=-1)
        base_lp = att_w * att_lp
        if lm_step_fn is not None and config.lm_weight > 0.0:
            if lm_cache is not None:
                lm_lp, lm_cache = lm_step_fn(tokens[:, step], step, lm_cache)
            else:
                lm_lp = lm_step_fn(tokens, step)
            base_lp = base_lp + config.lm_weight * lm_lp
        if use_ctc:
            # blank is not a transcript token: psi(g + blank) ~ psi(g) would
            # make it the best CTC delta
            vocab = torch.arange(v, device=dev)[None, :]
            base_lp = torch.where(vocab == config.blank_id, _NEG, base_lp)
            cand_lp, cand_ids = topk(base_lp, k)
            if config.ctc_defer_states:
                ctc_delta, cand_psi = ctc_prefix_score_only(
                    ctc_state, ctc_log_probs, enc_lengths, cand_ids, config.blank_id,
                    config.eos_id, beam=beam)
            else:
                ctc_delta, cand_states = ctc_prefix_score(
                    ctc_state, ctc_log_probs, enc_lengths, cand_ids, config.blank_id,
                    config.eos_id, beam=beam)
            step_scores = cand_lp + config.ctc_weight * ctc_delta
        else:
            step_scores, cand_ids = topk(base_lp, k)

        # finished rows: only candidate 0 survives, as eos at delta 0
        first = torch.arange(k, device=dev)[None, :] == 0
        step_scores = torch.where(finished[:, None], torch.where(first, 0.0, _NEG).to(
            step_scores.dtype), step_scores)
        cand_ids = torch.where(finished[:, None], config.eos_id, cand_ids)

        total = scores[:, None] + step_scores
        top_scores, top_idx = topk(total.reshape(batch, beam * k), beam)
        parent = (torch.div(top_idx, k, rounding_mode="floor") + utt_base).reshape(-1)
        cand = (top_idx % k).reshape(-1)

        chosen = cand_ids[parent, cand]
        tokens = tokens[parent]
        tokens[:, step + 1] = chosen
        was_finished = finished[parent]
        finished = was_finished | (chosen == config.eos_id)
        lengths = torch.where(finished, lengths[parent], lengths[parent] + 1)
        scores = top_scores.reshape(-1)
        if use_ctc:
            parent_state = CTCPrefixState(*(leaf[parent] for leaf in ctc_state))
            if config.ctc_defer_states:
                new_ctc = ctc_prefix_advance(parent_state, ctc_log_probs, enc_lengths, chosen,
                                             cand_psi[parent, cand], config.blank_id, beam=beam)
            else:
                new_ctc = ctc_prefix_select(cand_states, parent, cand)
            # finished rows keep their parent's state
            ctc_state = CTCPrefixState(
                r_nb=torch.where(was_finished[:, None], parent_state.r_nb, new_ctc.r_nb),
                r_b=torch.where(was_finished[:, None], parent_state.r_b, new_ctc.r_b),
                psi=torch.where(was_finished, parent_state.psi, new_ctc.psi),
                last=torch.where(was_finished, parent_state.last, new_ctc.last))

        if cache is not None:
            cache, cache_spare = _gather_rows(cache, cache_spare, parent, n)
        if lm_cache is not None:
            lm_cache, lm_spare = _gather_rows(lm_cache, lm_spare, parent, n)
        step += 1

    final = (scores / (lengths.to(torch.float32) + 1.0)).reshape(batch, beam)
    if nbest > 1:
        top_scores, order = topk(final, min(nbest, beam))
        flat = order + utt_base
        return tokens[flat][:, :, 1:], lengths[flat], top_scores
    best = final.argmax(dim=1)
    best_flat = best + utt_base[:, 0]
    return (tokens[best_flat][:, 1:], lengths[best_flat],
            final[torch.arange(batch, device=dev), best])


def tile_for_beam(x: torch.Tensor, beam: int) -> torch.Tensor:
    """`[B, ...]` -> `[B·beam, ...]`, each row repeated beam times."""
    return x.repeat_interleave(beam, dim=0)

"""Transducer decoding — the port of
`summarymixing_tpu/decoding/transducer_search.py`: greedy decoding, the
batched beam search with optional RNNLM shallow fusion (the recipes'
test stage: beam 10, state beam and expand beam 2.3, LM weight 0.5,
arXiv:1904.02619), and the sequential per-utterance beam search that
serves as its oracle.

Greedy: all rows advance together; every encoder frame runs a fixed
`max_symbols_per_frame` emit steps, and per-row `torch.where` selects
decide which rows take the emitted token and the predictor's new state,
as the JAX `lax.scan`/`fori_loop` does. Under `torch.export` the offline
loop over frames is a `scan`, so an exported graph takes any number of
frames. The argmax takes the lowest index
among equal logits, as `jnp.argmax` does.

Batched beam: fixed-width pools, the hypotheses kept `[B, beam]` and the
expansions `[B, beam + K]`, with `beam` where-gated rounds per frame and
a `valid_t` select that keeps a row past its length as it was. The
predictor's `(c, h)` and the LM's per-layer `(c, h)` pairs are pool
fields, tiled, gathered and concatenated like the others. Both top-k's
are stable descending sorts cut to k (`s2s_beam.topk`), which put the
lower index first among equal scores, as `jax.lax.top_k` does. Neither
search reads the device inside its loop over frames.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.decoding.s2s_beam import topk

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

    def frame(state, enc_frame, active):
        """One encoder frame's `max_symbols_per_frame` emit steps over the
        carry `(pred_state, dec_proj, tokens, lens)`."""
        pred_state, dec_proj, tokens, lens = state
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
        return pred_state, dec_proj, tokens, lens

    state = (tuple(pred_state), dec_proj, tokens, lens)
    if torch.compiler.is_exporting() and carry is None:
        # the offline graph under torch.export: the frames are a scan over
        # the leading axis, so the graph keeps T symbolic (a Python loop
        # would unroll it at the example's T); the body and its arithmetic
        # are the same. A streaming step (a carry) has a fixed chunk of
        # frames, and unrolls them
        from torch._higher_order_ops.scan import scan

        def body(carry, xs):
            new = frame(carry, *xs)
            return new, new[3].clone()   # scan stacks one output per frame: the lengths

        state, _ = scan(body, state, (enc_proj.transpose(0, 1), in_frame))
    else:
        for ti in range(t):
            state = frame(state, enc_proj[:, ti], in_frame[ti])
    pred_state, dec_proj, tokens, lens = state
    if return_carry:
        return tokens, lens, (pred_state, dec_proj, tokens, lens)
    return tokens, lens


_NEG = -1e30   # the score of an empty or dead hypothesis


def _tree_map(fn, *trees):
    """`fn` over the tensors of equally nested dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`mask` `[B]` or `[B, n]` with trailing axes to broadcast against `x`."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def transducer_beam_search_batched(enc_proj: torch.Tensor, enc_lengths: torch.Tensor,
                                   predictor_init: Callable, predictor_step: Callable,
                                   joint_step: Callable, blank_id: int = 0, bos_id: int = 0,
                                   beam_size: int = 10, state_beam: float = 2.3,
                                   expand_beam: float = 2.3, max_expand: Optional[int] = None,
                                   max_tokens: Optional[int] = None,
                                   lm_step: Optional[Callable] = None,
                                   lm_init: Optional[Callable] = None, lm_weight: float = 0.0,
                                   nbest: int = 1):
    """enc_proj `[B, T, J]` (after `proj_enc`), enc_lengths `[B]` ->
    (tokens `[B, Umax]`, lengths `[B]`, scores `[B]`): each row's best
    hypothesis, its score divided by its length + 1 (bos counted). With
    `nbest` > 1, the top min(nbest, beam) per row, score-sorted: `[B, n,
    Umax]`, `[B, n]`, `[B, n]`.

    Each frame pops the best unexpanded hypothesis at most `beam_size`
    times: its blank extension joins the frame's final pool, its non-blank
    expansions within `expand_beam` of the best (at most `max_expand`,
    default `beam_size`) join the pool, which is cut back to `beam_size`
    (a hypothesis below that rank could never be popped this frame); a
    row stops popping once its final pool is full or its best final
    hypothesis leads the best unexpanded one by `state_beam`. With an LM
    (`lm_init(B)`, `lm_step(carry, token [N]) -> (carry, logits)`) each
    expansion adds `lm_weight` times the LM's log-probability of its
    token. The result equals `transducer_beam_search`'s whenever
    `max_expand` covers every expansion within `expand_beam` (always for
    `max_expand >= vocab - 1`)."""
    b, t_max, _ = enc_proj.shape
    device = enc_proj.device
    beam = beam_size
    k_exp = max_expand or beam
    umax = max_tokens or t_max
    use_lm = lm_step is not None and lm_weight > 0.0
    enc_lengths = enc_lengths.to(device)

    state0, proj0 = predictor_step(predictor_init(b),
                                   torch.full((b,), bos_id, dtype=torch.long, device=device))

    def tile(x, n):
        return x[:, None].expand((b, n) + x.shape[1:]).contiguous()

    score0 = torch.full((b, beam), _NEG, dtype=torch.float32, device=device)
    score0[:, 0] = 0.0
    final = {"score": score0, "tokens": torch.zeros(b, beam, umax, dtype=torch.long, device=device),
             "len": torch.zeros(b, beam, dtype=torch.long, device=device),
             "last": torch.full((b, beam), bos_id, dtype=torch.long, device=device),
             "proj": tile(proj0, beam), "state": _tree_map(lambda x: tile(x, beam), state0)}
    if use_lm:
        final["lm"] = _tree_map(lambda x: tile(x, beam), lm_init(b))

    rows = torch.arange(b, device=device)
    slots = torch.arange(umax, device=device)
    beam_slots = torch.arange(beam, device=device)

    def gather_one(pool, idx):
        return _tree_map(lambda x: x[rows, idx], pool)

    def select_rows(pool, idx):
        return _tree_map(lambda x: x[rows[:, None], idx], pool)

    for ti in range(t_max):
        enc_frame = enc_proj[:, ti]
        valid_t = ti < enc_lengths
        proc = final
        fin = dict(final, score=torch.full((b, beam), _NEG, dtype=torch.float32, device=device))
        n_final = torch.zeros(b, dtype=torch.long, device=device)
        for _ in range(beam):
            p_idx = proc["score"].argmax(dim=1)
            p_best = proc["score"].max(dim=1).values
            f_best = fin["score"].max(dim=1).values
            stop = ((n_final >= beam) | ((n_final > 0) & (f_best >= state_beam + p_best))
                    | (p_best <= _NEG / 2))
            act = valid_t & ~stop
            sel = gather_one(proc, p_idx)
            n_pool = proc["score"].shape[1]
            popped = act[:, None] & (torch.arange(n_pool, device=device)[None, :]
                                     == p_idx[:, None])
            proc_score = torch.where(popped, _NEG, proc["score"])

            logp = torch.log_softmax(joint_step(enc_frame, sel["proj"]), dim=-1)
            v = logp.shape[-1]
            if use_lm:
                lm_new, lm_logits = lm_step(sel["lm"], sel["last"])
                lm_lp = torch.log_softmax(lm_logits, dim=-1)

            # the blank extension -> final slot n_final
            put = act[:, None] & (beam_slots[None, :] == n_final[:, None])

            def put_final(dst, src):
                return torch.where(_bcast(put, dst), src[:, None], dst)

            fin = _tree_map(put_final, fin, dict(sel, score=sel["score"] + logp[:, blank_id]))
            n_final = n_final + act.long()

            # the non-blank expansions: the top K within expand_beam
            k = min(k_exp, v - 1)
            nb_logp = logp.clone()
            nb_logp[:, blank_id] = _NEG
            top_lp, top_ids = topk(nb_logp, k)
            # a hypothesis whose token buffer is full can only take blank
            keep = ((top_lp >= top_lp[:, :1] - expand_beam) & act[:, None]
                    & (sel["len"] < umax)[:, None])
            exp_score = sel["score"][:, None] + top_lp
            if use_lm:
                exp_score = exp_score + lm_weight * torch.gather(lm_lp, 1, top_ids)
            exp_score = torch.where(keep, exp_score, _NEG)
            st_k = _tree_map(lambda x: tile(x, k).reshape((b * k,) + x.shape[1:]), sel["state"])
            new_state, new_proj = predictor_step(st_k, top_ids.reshape(-1))
            wpos = torch.clamp_max(sel["len"], umax - 1)
            exp = {"score": exp_score,
                   "tokens": torch.where((slots[None, None, :] == wpos[:, None, None]),
                                         top_ids[:, :, None], sel["tokens"][:, None, :]),
                   "len": torch.clamp_max(sel["len"] + 1, umax)[:, None].expand(b, k),
                   "last": top_ids,
                   "proj": new_proj.reshape(b, k, -1),
                   "state": _tree_map(lambda x: x.reshape((b, k) + x.shape[1:]), new_state)}
            if use_lm:
                exp["lm"] = _tree_map(lambda x: tile(x, k), lm_new)

            # compact [beam + K] -> the top beam
            pool = _tree_map(lambda a, x: torch.cat([a, x], dim=1),
                             dict(proc, score=proc_score), exp)
            _, top_idx = topk(pool["score"], beam)
            proc = select_rows(pool, top_idx)
        final = _tree_map(lambda new, old: torch.where(_bcast(valid_t, new), new, old), fin, final)

    norm = final["score"] / torch.clamp_min(final["len"].to(torch.float32) + 1.0, 1.0)
    norm = torch.where(final["score"] <= _NEG / 2, _NEG, norm)
    if nbest > 1:
        top_scores, order = topk(norm, min(nbest, beam))
        picked = select_rows({"tokens": final["tokens"], "len": final["len"]}, order)
        return picked["tokens"], picked["len"], top_scores
    best = norm.argmax(dim=1)
    return final["tokens"][rows, best], final["len"][rows, best], norm[rows, best]


@dataclass(eq=False)   # identity equality: list.remove must not compare tensors
class _Hyp:
    prediction: List[int]
    logp_score: float
    # the predictor's (state, proj) of a batch of hypotheses, and this one's row
    pred_rows: tuple
    row: int
    lm_state: Optional[list] = None

    def predictor_out(self):
        state, proj = self.pred_rows
        return _tree_map(lambda x: x[self.row:self.row + 1], state), proj[self.row:self.row + 1]


@torch.no_grad()
def transducer_beam_search(enc_proj_row: torch.Tensor, enc_length: int, predictor_init: Callable,
                           predictor_step: Callable, joint_step: Callable, blank_id: int = 0,
                           bos_id: int = 0, beam_size: int = 10, state_beam: float = 2.3,
                           expand_beam: float = 2.3, nbest: int = 1,
                           lm_step: Optional[Callable] = None,
                           lm_init: Optional[Callable] = None,
                           lm_weight: float = 0.0) -> List[Tuple[List[int], float]]:
    """One utterance's beam search, the reference algorithm with Python
    hypotheses (the JAX `transducer_beam_search`): enc_proj_row `[T, J]`.
    Returns the `nbest` best (tokens, score / len) pairs, bos counted in
    len, best first. The expansions of one pop advance the predictor in one
    call of K rows (the JAX search calls it once per expansion; each row is
    the same product), and a hypothesis keeps its row of that call."""
    device = enc_proj_row.device
    start = predictor_step(predictor_init(1),
                           torch.full((1,), bos_id, dtype=torch.long, device=device))
    use_lm = lm_step is not None and lm_weight > 0.0
    beam_hyps = [_Hyp([bos_id], 0.0, start, 0, lm_init(1) if use_lm else None)]
    for t in range(int(enc_length)):
        enc_frame = enc_proj_row[t:t + 1]
        process_hyps, beam_hyps = beam_hyps, []
        while len(beam_hyps) < beam_size:
            a_best = max(process_hyps, key=lambda h: h.logp_score)
            if beam_hyps:
                b_best = max(beam_hyps, key=lambda h: h.logp_score)
                if b_best.logp_score >= state_beam + a_best.logp_score:
                    break
            process_hyps.remove(a_best)
            state, dec_proj = a_best.predictor_out()
            logp = torch.log_softmax(joint_step(enc_frame, dec_proj), dim=-1)[0]
            logp = logp.cpu().numpy()
            if use_lm:
                lm_s, lm_logits = lm_step(a_best.lm_state,
                                          torch.tensor([a_best.prediction[-1]], device=device))
                lm_lp = torch.log_softmax(lm_logits, dim=-1)[0].cpu().numpy()
            beam_hyps.append(_Hyp(list(a_best.prediction),
                                  a_best.logp_score + float(logp[blank_id]),
                                  a_best.pred_rows, a_best.row, a_best.lm_state))
            best_logp = float(np.max(np.delete(logp, blank_id)))
            ks = []
            for k in np.argsort(logp)[::-1]:
                k = int(k)
                if k == blank_id:
                    continue
                if float(logp[k]) < best_logp - expand_beam:
                    break
                ks.append(k)
            if not ks:
                continue
            st = _tree_map(lambda x: x.expand((len(ks),) + x.shape[1:]), state)
            rows = predictor_step(st, torch.tensor(ks, device=device))
            for j, k in enumerate(ks):
                score = a_best.logp_score + float(logp[k])
                if use_lm:
                    score += lm_weight * float(lm_lp[k])
                process_hyps.append(_Hyp(a_best.prediction + [k], score, rows, j,
                                         lm_s if use_lm else a_best.lm_state))
    beam_hyps.sort(key=lambda h: h.logp_score / max(len(h.prediction), 1), reverse=True)
    return [(h.prediction[1:], h.logp_score / max(len(h.prediction), 1))
            for h in beam_hyps[:nbest]]

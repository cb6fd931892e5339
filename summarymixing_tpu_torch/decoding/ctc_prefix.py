"""Batched CTC prefix scoring for joint CTC/attention beam search — the port
of `summarymixing_tpu/decoding/ctc_prefix.py` (the hybrid CTC/attention
prefix scorer of Watanabe et al., 2017, batched over candidates).

For each hypothesis g and candidate token c, per frame t:

    r_nb[t, c] = x[t, c]     + logaddexp(r_nb[t-1, c], phi[t-1, c])
    r_b [t, c] = x[t, blank] + logaddexp(r_nb[t-1, c], r_b[t-1, c])
    phi[t, c]  = r_b_prev[t] (+ r_nb_prev[t] unless c == last(g))
    psi[c]     = logsumexp_t(phi[t-1, c] + x[t, c])

The score is the delta psi(g + c) - psi(g); an eos candidate scores the
whole-utterance probability logaddexp(r_nb[T-1], r_b[T-1]) - psi(g).

The recurrences have closed forms (C, B the cumulative sums of the
candidate's and blank's log-probs; clse an inclusive cumulative
log-sum-exp, `torch.logcumsumexp`):

    r_nb[t] = C[t] + clse_t(phi[t-1] - C[t-1])
    r_b [t] = B[t] + clse_t(r_nb[t-1] - B[t-1])

which is `impl="parallel"`, the default; `impl="scan"` is the sequential
recurrence over T, kept as the oracle. Padding frames contribute 0 to the
cumulative sums and are left out of psi; the scans are causal and padding
is a suffix, so what they compute there never reaches a valid frame. The
sentinels are the JAX package's: -1e5 is "log zero".

Rows: with `beam` > 1 the N = B·beam hypotheses map to utterance n // beam
of the UNtiled `[B, T, V]` lattice. The JAX package pads T to a size its
associative scans like; nothing here needs that, so T is not padded,
except in `compact_blank_frames` (blank-skip compaction,
`decoding.ctc_blank_skip` > 0), whose output keeps the JAX package's
shape so that both give the same lattice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_NEG = -1e5
# "log zero" of the compacted lattice's synthetic frames: -1e5 over hundreds
# of frames of cumulative sums would cost float32 precision; -1e3 still
# kills any path through one
_GAP_NEG = -1e3


def _pad_time_axis(n: int) -> int:
    """The JAX package's compacted time axis: from 128 up, the next
    multiple of 128; below, the next power of two."""
    if n >= 128:
        return -(-n // 128) * 128
    p = 1
    while p < n:
        p *= 2
    return p


class CTCPrefixState(NamedTuple):
    r_nb: torch.Tensor   # [N, T] the prefix ends in a non-blank, per frame
    r_b: torch.Tensor    # [N, T] the prefix ends in blank, per frame
    psi: torch.Tensor    # [N] prefix score
    last: torch.Tensor   # [N] last token of the prefix (-1 when empty)


def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


def _rows(x2d: torch.Tensor, beam: int) -> torch.Tensor:
    """`[B, T]` per-utterance values -> `[N, T]` per-hypothesis rows."""
    return x2d if beam == 1 else x2d.repeat_interleave(beam, dim=0)


def _gather_cand_lp(x: torch.Tensor, cand: torch.Tensor, beam: int) -> torch.Tensor:
    """Candidate log-probs `[N, T, K]` from the UNtiled `[B, T, V]` lattice:
    the K columns of each hypothesis are gathered per utterance, so only
    the `[N, T, K]` slice is ever beam-shaped."""
    n, k = cand.shape
    b, t, _ = x.shape
    if beam == 1:
        return torch.gather(x, 2, cand[:, None, :].expand(n, t, k))
    xc = torch.gather(x, 2, cand.reshape(b, 1, beam * k).expand(b, t, beam * k))
    return xc.reshape(b, t, beam, k).permute(0, 2, 1, 3).reshape(n, t, k)


def ctc_prefix_init(x: torch.Tensor, input_lengths: torch.Tensor, blank_id: int = 0,
                    beam: int = 1) -> CTCPrefixState:
    """The empty prefix's state. x `[B, T, V]` CTC log-probs; with `beam` >
    1 the state has N = B·beam rows and `input_lengths` is `[N]`."""
    t = x.shape[1]
    blank_lp = _rows(x[..., blank_id], beam)
    n = blank_lp.shape[0]
    blank_lp = torch.where(_valid(t, input_lengths), blank_lp, 0.0)
    r_b = torch.clamp(torch.cumsum(blank_lp, dim=1), min=_NEG)
    return CTCPrefixState(
        r_nb=torch.full((n, t), _NEG, dtype=x.dtype, device=x.device),
        r_b=r_b,
        psi=torch.zeros((n,), dtype=x.dtype, device=x.device),
        last=torch.full((n,), -1, dtype=torch.int64, device=x.device))


def _phi_shift(state: CTCPrefixState, cand: torch.Tensor) -> torch.Tensor:
    """phi at frame t-1 for every candidate, `[N, T, K]`: the parent's
    r_b (+ r_nb unless the candidate repeats the last token), shifted one
    frame, with the seed 0 for an empty prefix (else log zero)."""
    n, k = cand.shape
    same = cand == state.last[:, None]
    phi = torch.where(same[:, None, :], state.r_b[..., None],
                      torch.logaddexp(state.r_b, state.r_nb)[..., None])
    seed = torch.where(state.last < 0, 0.0, _NEG).to(phi.dtype)
    return torch.cat([seed[:, None, None].expand(n, 1, k), phi[:, :-1]], dim=1)


def _eos_score(state: CTCPrefixState, input_lengths: torch.Tensor) -> torch.Tensor:
    """logaddexp(r_nb, r_b) at each row's last valid frame, minus psi."""
    rows = torch.arange(state.r_nb.shape[0], device=state.r_nb.device)
    t_idx = torch.clamp(input_lengths - 1, min=0)
    full = torch.logaddexp(state.r_nb[rows, t_idx], state.r_b[rows, t_idx])
    return full - state.psi


def _psi(phi_shift: torch.Tensor, x_cand: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    terms = torch.where(valid[..., None], phi_shift + x_cand, _NEG)
    return torch.clamp(torch.logsumexp(terms, dim=1), min=_NEG)


def ctc_prefix_score(state: CTCPrefixState, x: torch.Tensor, input_lengths: torch.Tensor,
                     cand: torch.Tensor, blank_id: int = 0, eos_id: Optional[int] = None,
                     impl: str = "parallel",
                     beam: int = 1) -> Tuple[torch.Tensor, CTCPrefixState]:
    """Score K candidate extensions of each of N hypotheses. x `[B, T, V]`
    (`beam` > 1) or `[N, T, V]` (`beam` 1); cand `[N, K]`. Returns
    `(score_delta [N, K], candidate states)` with `r_nb`, `r_b` `[N, K, T]`
    and `psi`, `last` `[N, K]`; `ctc_prefix_select` picks the chosen ones."""
    t = x.shape[1]
    n, k = cand.shape
    valid = _valid(t, input_lengths)
    x_cand = _gather_cand_lp(x, cand, beam)
    if impl not in ("parallel", "scan"):
        raise ValueError(f"unknown impl {impl!r}")
    x_cand = torch.where(valid[..., None], x_cand, 0.0 if impl == "parallel" else _NEG)
    x_blank = torch.where(valid, _rows(x[..., blank_id], beam), 0.0)
    phi_shift = _phi_shift(state, cand)
    if impl == "parallel":
        c_cum = torch.cumsum(x_cand, dim=1)
        r_nb = torch.clamp(c_cum + torch.logcumsumexp(phi_shift - (c_cum - x_cand), dim=1),
                           min=_NEG)
        b_cum = torch.cumsum(x_blank, dim=1)[..., None]
        r_nb_shift = torch.cat([torch.full((n, 1, k), _NEG, dtype=x.dtype, device=x.device),
                                r_nb[:, :-1]], dim=1)
        r_b = torch.clamp(b_cum + torch.logcumsumexp(r_nb_shift - (b_cum - x_blank[..., None]),
                                                     dim=1), min=_NEG)
        psi = _psi(phi_shift, x_cand, valid)
    else:
        r_nb_p = torch.full((n, k), _NEG, dtype=x.dtype, device=x.device)
        r_b_p, psi = r_nb_p.clone(), r_nb_p.clone()
        r_nb_all, r_b_all = [], []
        for i in range(t):
            xc, phi_pm1 = x_cand[:, i], phi_shift[:, i]
            r_nb_t = torch.clamp(xc + torch.logaddexp(r_nb_p, phi_pm1), min=_NEG)
            r_b_t = torch.clamp(x_blank[:, i, None] + torch.logaddexp(r_nb_p, r_b_p), min=_NEG)
            psi = torch.clamp(torch.logaddexp(psi, phi_pm1 + xc), min=_NEG)
            r_nb_p, r_b_p = r_nb_t, r_b_t
            r_nb_all.append(r_nb_t)
            r_b_all.append(r_b_t)
        r_nb, r_b = torch.stack(r_nb_all, dim=1), torch.stack(r_b_all, dim=1)
    score = psi - state.psi[:, None]
    if eos_id is not None:
        score = torch.where(cand == eos_id, _eos_score(state, input_lengths)[:, None], score)
    return score, CTCPrefixState(r_nb=r_nb.transpose(1, 2), r_b=r_b.transpose(1, 2), psi=psi,
                                 last=cand)


def ctc_prefix_score_only(state: CTCPrefixState, x: torch.Tensor, input_lengths: torch.Tensor,
                          cand: torch.Tensor, blank_id: int = 0, eos_id: Optional[int] = None,
                          beam: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scores of `ctc_prefix_score` without the candidates' `[N, K, T]`
    states: psi, all that pruning needs, is logsumexp_t(phi[t-1] + x[t]);
    `ctc_prefix_advance` rebuilds the state of the chosen extensions.
    Returns `(score_delta [N, K], psi [N, K])`."""
    valid = _valid(x.shape[1], input_lengths)
    psi = _psi(_phi_shift(state, cand), _gather_cand_lp(x, cand, beam), valid)
    score = psi - state.psi[:, None]
    if eos_id is not None:
        score = torch.where(cand == eos_id, _eos_score(state, input_lengths)[:, None], score)
    return score, psi


def ctc_prefix_advance(state: CTCPrefixState, x: torch.Tensor, input_lengths: torch.Tensor,
                       token: torch.Tensor, psi: torch.Tensor, blank_id: int = 0,
                       beam: int = 1) -> CTCPrefixState:
    """The full state of ONE chosen extension per row: the closed forms of
    `ctc_prefix_score` at K = 1. `state` and `input_lengths` are the
    parent rows (already gathered by the beam's parent indices), `token`
    `[N]` the extension, `psi` `[N]` its score from
    `ctc_prefix_score_only`; x as in `ctc_prefix_score` (all rows of an
    utterance share its lattice, so x is never gathered)."""
    t = x.shape[1]
    n = token.shape[0]
    valid = _valid(t, input_lengths)
    xc = _gather_cand_lp(x, token[:, None], beam)[..., 0]
    xc = torch.where(valid, xc, 0.0)
    xb = torch.where(valid, _rows(x[..., blank_id], beam), 0.0)
    phi_shift = _phi_shift(state, token[:, None])[..., 0]
    c_cum = torch.cumsum(xc, dim=1)
    r_nb = torch.clamp(c_cum + torch.logcumsumexp(phi_shift - (c_cum - xc), dim=1), min=_NEG)
    b_cum = torch.cumsum(xb, dim=1)
    r_nb_shift = torch.cat([torch.full((n, 1), _NEG, dtype=x.dtype, device=x.device),
                            r_nb[:, :-1]], dim=1)
    r_b = torch.clamp(b_cum + torch.logcumsumexp(r_nb_shift - (b_cum - xb), dim=1), min=_NEG)
    return CTCPrefixState(r_nb=r_nb, r_b=r_b, psi=psi, last=token)


def ctc_prefix_select(cand_states: CTCPrefixState, hyp_idx: torch.Tensor,
                      cand_idx: torch.Tensor) -> CTCPrefixState:
    """The chosen candidates' states: `[N']` indices into the N and K axes."""
    return CTCPrefixState(*(leaf[hyp_idx, cand_idx] for leaf in cand_states))


def compact_blank_frames(x: torch.Tensor, input_lengths: torch.Tensor, blank_id: int = 0,
                         keep_cap: int = 0, blank_threshold: float = 0.95
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shrink the CTC time axis by collapsing blank-dominated frames (the
    JAX package's blank-skip pre-pass). A frame whose blank probability is
    at least `blank_threshold` is treated as carrying no non-blank mass;
    over a run of such frames the scorer's recurrence is exactly one
    synthetic frame whose blank log-prob is the run's sum and whose other
    entries are log zero. So: keep the other frames verbatim, replace each
    dropped run by one synthetic blank frame, and append one trailing
    synthetic frame holding the blank tail (eos scoring reads it). At
    `blank_threshold` 1.0 with no cap every valid frame is kept and the
    scores are those of the full lattice.

    x `[B, T, V]` CTC log-probs, untiled (what is kept depends on the
    utterance, not the hypothesis); `input_lengths` `[B]`; `keep_cap` the
    most frames kept per row (0: T): a row with more candidates keeps the
    ones with the most non-blank mass, the lower frame first among equals
    (`jax.lax.top_k`'s order). Returns `(x2 [B, T2, V], lengths2 [B],
    kept_count [B])`, T2 the JAX package's padded size of 2·cap + 1
    (`_pad_time_axis`); slots past `lengths2` hold a blank of log-prob 0."""
    b, t, v = x.shape
    dev = x.device
    cap = min(keep_cap, t) if keep_cap else t
    lengths = input_lengths.to(torch.int64)
    blank_lp = x[..., blank_id]
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    thresh = torch.log(torch.tensor(blank_threshold, dtype=x.dtype, device=dev))
    keep = valid & (blank_lp < thresh)

    # the cap: the `cap` frames with the most non-blank mass
    score = torch.where(keep, -blank_lp, float("-inf"))
    kept_t = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :cap]
    kept_valid = torch.gather(keep, 1, kept_t)
    kept_count = kept_valid.sum(dim=1)
    # time order, the slots not kept pushed past the end (sentinel t)
    t_i = torch.sort(torch.where(kept_valid, kept_t, t), dim=1).values
    i_idx = torch.arange(cap, device=dev)[None, :]
    is_kept = i_idx < kept_count[:, None]
    t_prev = torch.cat([torch.full((b, 1), -1, dtype=t_i.dtype, device=dev), t_i[:, :-1]], dim=1)

    # blank log-prob sums over valid frames: cs_pad[:, j] sums frames < j
    cs_pad = torch.cat([torch.zeros((b, 1), dtype=x.dtype, device=dev),
                        torch.cumsum(torch.where(valid, blank_lp, 0.0), dim=1)], dim=1)
    # the dropped run strictly between t_prev and t_i (past the kept slots
    # t_prev is the sentinel: clamped, as JAX clamps a gather)
    gap_sum = (torch.gather(cs_pad, 1, t_i)
               - torch.gather(cs_pad, 1, torch.clamp(t_prev + 1, max=t)))
    has_gap = is_kept & (t_i - t_prev > 1)
    # kept frame i lands at i + (gaps at or before it); its gap frame, if
    # any, just before it
    gaps_incl = torch.cumsum(has_gap.to(torch.int64), dim=1)
    pos = i_idx + gaps_incl
    t2 = _pad_time_axis(2 * cap + 1)
    # one slot more than the output: writes that the JAX scatter drops
    # (slots not kept, rows without a gap) land there and are cut off
    out = torch.full((b, t2 + 1, v), _GAP_NEG, dtype=x.dtype, device=dev)
    out[:, :, blank_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None]
    src = torch.gather(x, 1, torch.clamp(t_i, max=t - 1)[..., None].expand(b, cap, v))
    out[rows, torch.where(is_kept, pos, t2)] = src
    out[rows, torch.where(has_gap, pos - 1, t2), blank_id] = gap_sum

    # the trailing synthetic frame: the blanks after the last kept frame
    row1 = rows[:, 0]
    last = torch.gather(t_i, 1, torch.clamp(kept_count - 1, min=0)[:, None])[:, 0]
    last_kept_next = torch.where(kept_count > 0, last + 1, 0)
    tail_sum = cs_pad[row1, lengths] - cs_pad[row1, last_kept_next]
    pos_tail = kept_count + gaps_incl[:, -1]
    out[row1, pos_tail] = _GAP_NEG
    out[row1, pos_tail, blank_id] = tail_sum
    return out[:, :t2], pos_tail + 1, kept_count

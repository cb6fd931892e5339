"""Greedy decode entry points of the port: waveforms in, token ids out.

The counterpart of the JAX package's `recipes/transcribe.py` batching and
of its two branches: `greedy_ctc_decode` (the attention recipes,
`ASRTrainer.eval_step`: Fbank -> frame lengths -> InputNormalization with
frozen statistics -> `SpeechRecognizer` -> greedy CTC -> collapse) and
`transducer_greedy_transcribe` (the transducer recipes: the same encoder
input, the Conformer encoder, `proj_enc`, then the transducer's greedy
decode). Token ids are not turned into text here; the runners of
`recipes/` do that with the run's tokenizer (`data/tokenizer.py`).

    model, fbank = build_model(cfg)                 # on the card
    for idx, wav, lens in batch_waveforms(wavs, 8, 8000):
        hyps, out = greedy_ctc_decode(model, fbank, norm_stats, wav, lens)

    model, fbank, transducer = build_model(transducer_cfg)
    hyps, out = transducer_greedy_transcribe(model, transducer, fbank, norm_stats, wav, lens)
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from summarymixing_tpu_torch.decoding.ctc import collapse_ctc, ctc_greedy_decode
from summarymixing_tpu_torch.decoding.transducer_search import transducer_greedy_decode
from summarymixing_tpu_torch.frontend.features import InputNormalization
from summarymixing_tpu_torch.training.profiling import span
from summarymixing_tpu_torch.utils.device import resolve_device


def batch_waveforms(wavs: Sequence[np.ndarray], batch_size: int, pad_quantum: int,
                    device=None) -> Iterator[Tuple[List[int], torch.Tensor, torch.Tensor]]:
    """Yield `(indices, wav [B, N] float32, wav_lens [B] int32)` on `device`
    (the card unless told otherwise). Waveforms are sorted by length,
    longest first; N is rounded up to a multiple of `pad_quantum` samples;
    the last batch is filled by repeating its last waveform."""
    device = resolve_device(device)
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]), reverse=True)
    for start in range(0, len(order), batch_size):
        chunk = order[start:start + batch_size]
        chunk += [chunk[-1]] * (batch_size - len(chunk))
        n = max(len(wavs[i]) for i in chunk)
        n = -(-n // pad_quantum) * pad_quantum
        wav = np.zeros((batch_size, n), np.float32)
        lens = np.zeros((batch_size,), np.int32)
        for j, i in enumerate(chunk):
            wav[j, :len(wavs[i])] = wavs[i]
            lens[j] = len(wavs[i])
        yield (chunk, torch.from_numpy(wav).to(device), torch.from_numpy(lens).to(device))


@torch.inference_mode()
def greedy_ctc_decode(model, fbank, norm_stats: dict, wav: torch.Tensor,
                      wav_lens: torch.Tensor) -> Tuple[List[List[int]], dict]:
    """Decode one batch (blank id 0): returns the token ids per row and the
    model's output dict (`ctc_log_probs`, `enc_lengths`, ...). Its phases
    are the profiler spans `decode.features`, `decode.model`,
    `decode.search` and `decode.collapse` (the host read and lists)."""
    with span("decode.features"):
        feats = fbank(wav)
        feat_len = fbank.frame_lengths(wav_lens)
        feats, _ = InputNormalization()(feats, norm_stats)
    with span("decode.model"):
        out = model(feats, feat_len)
    with span("decode.search"):
        ids, keep = ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"])
    with span("decode.collapse"):
        return collapse_ctc(ids, keep), out


@torch.inference_mode()
def transducer_greedy_transcribe(model, transducer, fbank, norm_stats: dict, wav: torch.Tensor,
                                 wav_lens: torch.Tensor,
                                 blank_id: int = 0) -> Tuple[List[List[int]], dict]:
    """Decode one batch with a transducer: Fbank -> normalisation -> the
    encoder (offline, full context) -> `proj_enc` -> greedy decode. Returns
    the token ids per row (one host read) and a dict with `enc_out`,
    `enc_lengths`, `tokens` `[B, 2T']` and `lengths`."""
    feats, _ = InputNormalization()(fbank(wav), norm_stats)
    enc_out, enc_lens = model.encode(feats, fbank.frame_lengths(wav_lens))
    tokens, lens = transducer_greedy_decode(
        transducer.encode_proj(enc_out), enc_lens, transducer.predictor_init,
        transducer.predictor_step, transducer.joint_step, blank_id=blank_id)
    toks, n = tokens.cpu(), lens.cpu()
    hyps = [toks[i, :int(n[i])].tolist() for i in range(toks.shape[0])]
    return hyps, {"enc_out": enc_out, "enc_lengths": enc_lens, "tokens": tokens, "lengths": lens}

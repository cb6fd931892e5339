"""The kernels' wrappers swapped for their plain versions, so that one
model can be run once with the kernels and once without them on the same
card and the two results compared (`chip_smoke.py`, the `flagship` WER
protocol). The models call the wrappers through the module attributes
`fused_summary.fused_summary_mixing`, `fused_csgu.fused_convolution_branch`
and `attention.fused_relpos_attention`, so the swap reaches every cell,
cgMLP branch and RelPosMHAXL call the kernels take; the plain versions run
on the bf16-cast weights (and bf16 projections) the kernels take, and
autograd differentiates them. The swapped-in functions count nothing."""

from __future__ import annotations

import contextlib

from summarymixing_tpu_torch.ops import attention, fused_csgu, fused_summary


@contextlib.contextmanager
def plain_kernels():
    saved = (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch,
             attention.fused_relpos_attention)

    def cell(x, pad, weights, activation, keep=None, keep_prob=1.0, launch_weights=None):
        return fused_summary.summary_mixing_reference(
            x, pad, fused_summary.kernel_weights(weights), activation, keep, keep_prob)

    def branch(x, mask, weights, eps, keep=None, keep_prob=1.0, launch_weights=None):
        return fused_csgu.convolution_branch_reference(
            x, mask, fused_csgu.kernel_weights(weights), eps, keep, keep_prob)

    def relpos(q, k, v, p, pos_bias_u, pos_bias_v, pad_mask=None, causal=False):
        return attention.relpos_attention_reference(q, k, v, p, pos_bias_u, pos_bias_v, None,
                                                    pad_mask, causal)

    (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch,
     attention.fused_relpos_attention) = cell, branch, relpos
    try:
        yield
    finally:
        (fused_summary.fused_summary_mixing, fused_csgu.fused_convolution_branch,
         attention.fused_relpos_attention) = saved

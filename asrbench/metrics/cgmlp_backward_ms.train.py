"""Device milliseconds per traced step of the kernels launched inside the
program's `train.cgmlp_backward` span (`ops.fused_csgu.FusedConvolutionBranch`'s
backward: the cgMLP branch's backward kernels, once per Branchformer layer,
opened in autograd's thread). None where no card was traced or the program
opens no such span."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    spent = ctx.spans.span_device_s.get("train.cgmlp_backward", 0.0)
    if spent <= 0:
        return None
    return 1000.0 * spent / ctx.stretch_units

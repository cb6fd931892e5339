"""The cgMLP branch (`ops.fused_csgu` -> `csrc/csgu.cu`): the least time its
mathematics needs at each traced call's shapes (`yardstick.counts.cgmlp_call`),
over the device time of the kernels launched inside the `ConvolutionBranch`
modules' forwards."""

MODULES = ("ConvolutionBranch",)


def read(ctx):
    spent = ctx.trace.module_s.get("ConvolutionBranch", 0.0)
    if spent <= 0:
        return None
    need = sum(ctx.counts.bound_s(*ctx.counts.cgmlp_call(ctx.model, b, t))
               for b, t, _ in ctx.calls["ConvolutionBranch"])
    return 100.0 * need / spent

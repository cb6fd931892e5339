"""Training losses of the port: CTC, the label-smoothed KL divergence, the
masked NLL and the RNN-T loss."""

from summarymixing_tpu_torch.losses.ctc import ctc_loss
from summarymixing_tpu_torch.losses.kldiv import kldiv_loss, nll_loss
from summarymixing_tpu_torch.losses.transducer import transducer_loss, transducer_loss_chunked

__all__ = ["ctc_loss", "kldiv_loss", "nll_loss", "transducer_loss", "transducer_loss_chunked"]

"""autoencoding (scail_tpu_torch): the first stages and their training stack
(counterpart of scail_tpu/autoencoding): the KL autoencoder, VQModel and
MOVQ, the MagViT2-lite video tokenizer, the KL / VQ / EMA-VQ / LFQ
regularizers, both GAN discriminators and losses, and AutoencoderTrainer."""

from scail_tpu_torch.autoencoding.regularizers import (  # noqa: F401
    LFQ, EMAVectorQuantizer, VectorQuantizer,
    diagonal_gaussian_regularizer, lfq_entropy_terms, measure_perplexity)
from scail_tpu_torch.autoencoding.discriminator import (  # noqa: F401
    NLayerDiscriminator, VideoDiscriminator)
from scail_tpu_torch.autoencoding.gan_loss import (  # noqa: F401
    LPIPSWithDiscriminator, VideoAutoencoderLoss, hinge_d_loss, hinge_discr_loss,
    hinge_gen_loss, pick_video_frame, vanilla_d_loss)
from scail_tpu_torch.autoencoding.engine import AutoencoderTrainer  # noqa: F401

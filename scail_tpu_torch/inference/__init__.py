"""The SD-family image inference API on PyTorch (counterpart of scail_tpu/inference/)."""

from scail_tpu_torch.inference.api import (Discretization, Guider,  # noqa: F401
                                           ModelArchitecture, Sampler, SamplingParams,
                                           SamplingPipeline, SamplingSpec, Thresholder,
                                           get_discretization_config, get_guider_config,
                                           get_sampler_config, model_specs)
from scail_tpu_torch.inference.helpers import (Img2ImgDiscretizationWrapper,  # noqa: F401
                                               do_img2img, do_sample)
from scail_tpu_torch.inference.watermark import (WATERMARK_BITS,  # noqa: F401
                                                 WatermarkEmbedder, decode_watermark,
                                                 embed_watermark)

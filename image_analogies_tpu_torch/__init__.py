"""image_analogies_tpu_torch: the PyTorch/CUDA port of image-analogies-tpu.

Image Analogies (Hertzmann et al. 2001) with PatchMatch search and
Ashikhmin coherence, on an NVIDIA Hopper card.  The JAX package
`image_analogies_tpu` is the reference this port is held against; the
port imports nothing of it, and nothing of JAX.
"""

from .config import SynthConfig
from .models.analogy import create_image_analogy, load_level_state
from .parallel.batch import synthesize_batch
from .utils.metrics import psnr
from .video import VideoStream, synthesize_video

__all__ = ["SynthConfig", "VideoStream", "create_image_analogy",
           "load_level_state", "psnr", "synthesize_batch",
           "synthesize_video"]

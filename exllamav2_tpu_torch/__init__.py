"""exllamav2_tpu_torch: the PyTorch / CUDA port of exllamav2_tpu.

Same module layout and names as the JAX package, which stays the reference.
The decode hot path runs hand-written CUDA kernels for Hopper (``csrc/``,
built by ``_build`` at first use); every kernel has a plain PyTorch version
beside it, which is what runs for tensors on the CPU.
"""

from exllamav2_tpu_torch.config import ModelConfig                 # noqa: F401
from exllamav2_tpu_torch.cache import KVCache                      # noqa: F401
from exllamav2_tpu_torch.models.model import Model                 # noqa: F401

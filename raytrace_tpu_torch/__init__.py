"""raytrace_tpu_torch: the ray-trace miniapp on PyTorch and CUDA.

The port of ``raytrace_tpu`` (JAX on a TPU) to one NVIDIA H100: the same
``create_image`` main path, with the trace and deposit kernels written by
hand in CUDA C++ for ``sm_90a`` (``csrc/``) and plain PyTorch twins of both
for the CPU. This package imports ``torch`` and never ``jax`` or
``raytrace_tpu``.
"""

from raytrace_tpu_torch.io.loader import load_input, save_input
from raytrace_tpu_torch.models.ray_tracer import create_image
from raytrace_tpu_torch.structures import CreateImageProblem
from raytrace_tpu_torch.testing import synthetic_problem
from raytrace_tpu_torch.utils.stats import check_ans

__all__ = ["load_input", "save_input", "create_image", "CreateImageProblem",
           "synthetic_problem", "check_ans"]

# forge3d_tpu_torch/assurance: render certificates (a copy of the JAX
# package's certificate module).
from . import certificate  # noqa: F401

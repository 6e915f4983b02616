from fastvlm_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from fastvlm_tpu_torch.parallel import sharding  # noqa: F401

"""Batched proof verification (`BatchVerifier`) and the MSM sharded over a
mesh of devices (`make_mesh`, `sharded_msm_lanes`), as the JAX package's
`parallel`; `Mesh` also builds a mesh by hand (a device may repeat)."""

from .sharded_msm import Mesh, make_mesh, sharded_msm_lanes
from .batch_verify import BatchVerifier

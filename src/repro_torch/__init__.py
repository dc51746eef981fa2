"""PyTorch/CUDA port of ``repro``: parallel dynamic spatial indexes on an
NVIDIA H100.

The package mirrors ``repro``'s module layout so every module's
counterpart sits at the same relative path:

  * ``repro_torch.core``    -- SFC encodings, leaf-row machinery, the
    P-Orth tree, the SPaC-tree family, the kd / Zd baselines, the query
    engine and the ``make_index`` facade
  * ``repro_torch.kernels`` -- hand-written CUDA kernels (flat and
    frontier kNN, the sieve, row bounding boxes, Morton encode) with a
    plain PyTorch version beside each
  * ``repro_torch.data``    -- numpy workload generators and traces
  * ``repro_torch.serving`` -- the versioned ``SpatialServer`` and the
    ``MicroBatcher``

Entry points run on the card unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`). Importing the package touches no device
and compiles nothing: kernels are built with ``nvcc`` at first launch.
"""

__version__ = "0.1.0"

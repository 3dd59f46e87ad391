"""tpukzg_torch — KZG batch verification on BLS12-381 in PyTorch and CUDA.

A port of the JAX package ``tpukzg`` to one NVIDIA H100.  It imports
torch and numpy only.  Hand-written Hopper kernels live in ``csrc/``
(built on first use into ``build/``), each with a plain tensor version
beside its wrapper in ``kernels/``.
"""

from tpukzg_torch.api import (  # noqa: F401
    TrustedSetup,
    generate_insecure_setup,
    load_setup_file,
    verify_blob_kzg_proof_batch,
)

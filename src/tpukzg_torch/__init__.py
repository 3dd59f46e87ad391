"""tpukzg_torch — KZG commitments, proofs and batch verification on
BLS12-381 in PyTorch and CUDA.

A port of the JAX package ``tpukzg`` to one NVIDIA H100.  It imports
torch and numpy only.  Hand-written Hopper kernels live in ``csrc/``
(built on first use into ``build/``), each with a plain tensor version
beside its wrapper in ``kernels/``.
"""

from tpukzg_torch.api import (  # noqa: F401
    TrustedSetup,
    blob_to_kzg_commitment,
    blob_to_kzg_commitment_batch,
    compute_blob_kzg_proof,
    compute_blob_kzg_proof_batch,
    compute_kzg_proof,
    generate_insecure_setup,
    load_setup_file,
    load_trusted_setup,
    verify_blob_kzg_proof,
    verify_blob_kzg_proof_batch,
    verify_blob_kzg_proof_batch_async,
    verify_blob_kzg_proof_batch_chunked,
    verify_blob_kzg_proof_batch_pipeline,
    verify_kzg_proof,
)

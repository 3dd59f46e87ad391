"""The plain reference: pure Python integers and NumPy, nothing of the
program.  `bls` holds the field and G1 arithmetic of BLS12-381 (a frozen
copy of the parts of the repository's pure-Python model that the checks
use), `kzg` the blob commitment, proof, verdict and MSM answers worked
out from the inputs and the setup's tau."""

"""mlease_tpu_torch — the PyTorch / CUDA port of mlease_tpu.

A second package beside the JAX one: the same consensus-ADMM logistic
regression, job-file keys and Avro output layout, written in PyTorch for an
NVIDIA H100. It imports nothing of the JAX package; the host modules it
shares in function (Avro codec, vocab, prepare, packing) are copies. Entry
points run on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

"""PyTorch/CUDA port of ``variantcalling_tpu`` (filter_variants_pipeline: forest, threshold and DAN models).

The JAX package beside this one is the reference: module names mirror its
layout so each module's counterpart is easy to find, and the port's
outputs are held to the reference's output bytes. This package imports
``torch``, numpy and the standard library only — never ``jax`` and never
``variantcalling_tpu``; what it needs from the reference it keeps as its
own copy.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--backend cpu`` on the CLI, ``device="cpu"`` in the API).
"""

__version__ = "0.1.0"

"""ydf_tpu_torch — the PyTorch/CUDA port of ydf_tpu.

Serving slice: load a model saved by the JAX package and score it on an
NVIDIA H100 (sm_90a) through hand-written CUDA kernels.

    import ydf_tpu_torch as ydf
    model = ydf.load_model("path/to/model")      # device="cuda" by default
    model.predict(data)                          # numpy, like the JAX package

Entry points run on the card unless the caller passes `device="cpu"`;
on a CPU tensor every kernel wrapper runs its plain PyTorch version.
"""

from ydf_tpu_torch.models.io import forest_from_jax, load_model

__all__ = ["forest_from_jax", "load_model"]

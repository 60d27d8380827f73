"""PyTorch/CUDA port of speechclip_plus_tpu (SpeechCLIP+), for NVIDIA Hopper.

The JAX package `speechclip_plus_tpu` is the untouched reference; this package
mirrors its layout and module names. It imports torch and never jax.
Entry points: `api.SpeechCLIP`, `serving.build_image_index`,
`serving.SpeechRetriever`, `tasks.builder.build_model_from_config`.
"""
__version__ = "0.1.0"

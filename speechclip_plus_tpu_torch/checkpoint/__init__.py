"""Checkpoints: the training checkpoint manager (`manager`), the reference
PyTorch importers (Lightning `.ckpt` files, fairseq / HF / OpenAI towers) and
the JAX-variables weight bridge (`from_jax`)."""
from .lightning_import import lightning_to_kwclip, load_lightning_checkpoint  # noqa: F401
from .manager import CheckpointManager  # noqa: F401
from .torch_import import load_port_state_dict, load_torch_state_dict  # noqa: F401
from .towers import (  # noqa: F401
    clip_config_from_openai_sd,
    fairseq_hubert_to_port,
    hf_clip_to_port,
    hf_data2vec_audio_to_port,
    hf_hubert_to_port,
    hf_wavlm_to_port,
    hubert_config_from_fairseq_sd,
    materialize_weight_norm,
    openai_clip_to_port,
    reduce_token_embedding,
)

"""Named task entry (port of ``speechclip_plus_tpu/tasks/train_kwclip.py``;
reference ``avssl/task/train_KWClip.py:5-10``)."""
from .base_task import TrainSpeechClipBaseTask

__all__ = ["TrainKWClip_GeneralTransformer"]


class TrainKWClip_GeneralTransformer(TrainSpeechClipBaseTask):
    """Train/eval the KWClip general-transformer model family."""

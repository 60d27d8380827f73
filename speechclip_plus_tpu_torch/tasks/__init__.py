"""Task layer: CLI arg parsing, dataset/loader construction, trainer loop
(port of ``speechclip_plus_tpu/tasks``; reference ``avssl/task/``,
`base_task.py:17-215`, `train_KWClip.py:5-10`)."""
from .args import add_general_arguments  # noqa: F401
from .base_task import BaseTask, TrainSpeechClipBaseTask  # noqa: F401
from .builder import build_model_from_config  # noqa: F401
from .train_kwclip import TrainKWClip_GeneralTransformer  # noqa: F401
from .trainer import Trainer  # noqa: F401

"""Model towers and SpeechCLIP(+) branch/model assemblies."""
from .branches import (  # noqa: F401
    CascadedBranch,
    CascadedBranchPlus,
    HybridBranch,
    HybridBranchPlus,
    KeywordHeadConfig,
    KwBnConfig,
    ParallelBranch,
    TransformerArgs,
    VQConfig,
)
from .cif import CIF, CifConfig  # noqa: F401
from .clip import ClipConfig, ClipModel, TextTransformer, VisionTransformer  # noqa: F401
from .kwclip import (  # noqa: F401
    ClLossConfig,
    KWClip,
    KWClipConfig,
    init_kw_bn_from_token_embedding,
)
from .hubert import HubertConfig, HubertModel, downsample_padding_mask  # noqa: F401
from .mel_upstreams import (  # noqa: F401
    MelUpstream,
    MelUpstreamConfig,
    import_torch_lstm_state,
)

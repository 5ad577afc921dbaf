"""Reference checkpoints into the port (counterpart of f5tts_tpu/compat)."""

from f5tts_tpu_torch.compat.torch_import import (  # noqa: F401
    convert_backbone_state_dict,
    convert_backbone_state_dict_audited,
    convert_f5tts_state_dict,
    convert_unett_state_dict,
    convert_vocos_state_dict,
    extract_ema_state_dict,
    load_torch_checkpoint,
)
from f5tts_tpu_torch.vocoder.bigvgan import convert_bigvgan_state_dict  # noqa: F401

from f_lite_tpu_torch.text.encoder import (
    PrecomputedTextEncoder,
    T5TextEncoder,
    TextEncoder,
    TorchTextEncoder,
    ZeroTextEncoder,
)
from f_lite_tpu_torch.text.templates import (
    inference_chat_messages,
    training_chat_messages,
)

__all__ = [
    "TextEncoder",
    "T5TextEncoder",
    "TorchTextEncoder",
    "PrecomputedTextEncoder",
    "ZeroTextEncoder",
    "inference_chat_messages",
    "training_chat_messages",
]

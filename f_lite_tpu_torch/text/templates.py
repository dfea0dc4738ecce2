"""Chat-template messages for chat-style text encoders (counterpart of
`f_lite_tpu/text/templates.py`, the same strings).

Captions are wrapped in a chat template with a fixed system prompt before
encoding: one prompt at inference, and at training one chosen by the
sample's `media_type` metadata. These functions build the message list; the
encoder's tokenizer applies its own chat template. T5-era encoders take raw
captions.
"""

from __future__ import annotations

INFERENCE_SYSTEM_PROMPT = (
    "You are a text-to-image generation model engineered to transform "
    "user-provided textual captions directly into high-quality, visually "
    "rich image tokens. Your core objective is to generate the best "
    "possible, highest-fidelity image that creatively interprets and "
    "expands upon the user's intent while maintaining strong semantic "
    "alignment with the original caption. You are designed for maximum "
    "visual quality, artistic flair, and implicit adherence to best "
    "practices in image generation (e.g., proper anatomy, clear focus, "
    "compelling composition), ensuring a stunning visual result from even "
    "concise descriptions."
)

TRAIN_SYSTEM_PROMPT_REAL = (
    "You are an assistant designed to generate high-quality images based "
    "on user prompts. Generate images that are realistic and high-quality."
)

TRAIN_SYSTEM_PROMPT_NONREAL = (
    "You are an assistant designed to generate high-quality images based "
    "on user prompts. The image doesn't need to be realistic, but it "
    "should be high-quality."
)


def inference_chat_messages(caption: str) -> list[dict]:
    """Message list for inference encoding."""
    return [
        {"role": "system", "content": INFERENCE_SYSTEM_PROMPT},
        {"role": "user", "content": [{"type": "text", "text": caption}]},
    ]


def training_chat_messages(caption: str, metadata: dict | None = None) -> list[dict]:
    """Message list for training encoding; the system prompt depends on
    the `media_type` metadata ("real" by default)."""
    media_type = (metadata or {}).get("media_type", "real")
    system = (
        TRAIN_SYSTEM_PROMPT_REAL
        if media_type == "real"
        else TRAIN_SYSTEM_PROMPT_NONREAL
    )
    return [
        {"role": "system", "content": system},
        {
            "role": "user",
            "content": [{"type": "text", "text": f"Caption: \n\n{caption}"}],
        },
    ]

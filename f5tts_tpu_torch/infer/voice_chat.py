"""Voice chat: ASR -> chat LLM -> TTS in the reference voice (counterpart of
f5tts_tpu/infer/voice_chat.py; the reference gradio app's voice-chat tab,
src/f5_tts/infer/infer_gradio.py:739-1000), with no UI.

The three stages are callables the caller passes. The defaults load Hugging
Face models when first used: `load_chat_model` imports `transformers` then
(the card's machine has none), `default_asr` is `asr.transcribe`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

DEFAULT_CHAT_MODELS = ["Qwen/Qwen2.5-3B-Instruct", "microsoft/Phi-4-mini-instruct"]
DEFAULT_SYSTEM_PROMPT = (
    "You are a friendly conversational partner. Keep every reply short and "
    "natural, like spoken dialogue — one or two sentences, no lists, no "
    "markdown, nothing that cannot be read aloud."
)


def load_chat_model(name: str = DEFAULT_CHAT_MODELS[0]) -> Callable[[list[dict]], str]:
    """Returns messages -> reply using a HF causal LM (reference :757-768),
    read from a directory or the local Hugging Face cache: nothing is
    downloaded."""
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(name, torch_dtype="auto", local_files_only=True)

    def chat(messages: list[dict]) -> str:
        ids = tok.apply_chat_template(messages, add_generation_prompt=True,
                                      return_tensors="pt")
        out = model.generate(ids, max_new_tokens=512, do_sample=True,
                             temperature=0.7)
        return tok.decode(out[0][ids.shape[1]:], skip_special_tokens=True).strip()

    return chat


def default_asr() -> Callable[[np.ndarray, int], str]:
    from f5tts_tpu_torch.infer.asr import transcribe

    return transcribe


@dataclass
class VoiceChatEngine:
    """Stateful conversation: feed text or audio, get (reply_text, wav, sr)."""

    tts: Callable            # (ref_wav, ref_sr, ref_text, gen_text) -> (wav, sr)
    chat: Optional[Callable] = None     # messages -> reply (lazy default LLM)
    asr: Optional[Callable] = None      # (wav, sr) -> text (lazy default whisper)
    system_prompt: str = DEFAULT_SYSTEM_PROMPT
    chat_model_name: str = DEFAULT_CHAT_MODELS[0]
    history: list = field(default_factory=list)

    def _chat(self) -> Callable:
        if self.chat is None:
            self.chat = load_chat_model(self.chat_model_name)
        return self.chat

    def _asr(self) -> Callable:
        if self.asr is None:
            self.asr = default_asr()
        return self.asr

    def reset(self) -> None:
        self.history = []

    def respond_to_text(self, message: str, ref_wav: np.ndarray, ref_sr: int,
                        ref_text: str) -> tuple[str, np.ndarray, int]:
        messages = ([{"role": "system", "content": self.system_prompt}]
                    + self.history + [{"role": "user", "content": message}])
        reply = self._chat()(messages)
        self.history = self.history + [
            {"role": "user", "content": message},
            {"role": "assistant", "content": reply},
        ]
        wav, sr = self.tts(ref_wav, ref_sr, ref_text, reply)
        return reply, wav, sr

    def respond_to_audio(self, message_wav: np.ndarray, message_sr: int,
                         ref_wav: np.ndarray, ref_sr: int,
                         ref_text: str) -> tuple[str, str, np.ndarray, int]:
        """Spoken message: transcribe, then respond. Returns
        (transcript, reply_text, wav, sr)."""
        transcript = self._asr()(message_wav, message_sr)
        reply, wav, sr = self.respond_to_text(transcript, ref_wav, ref_sr, ref_text)
        return transcript, reply, wav, sr

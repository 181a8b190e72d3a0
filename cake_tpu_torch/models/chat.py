"""Chat message types and the prompt templates.

Counterpart of `cake_tpu/models/chat.py` (host-only, copied). The
Llama-3 rendering follows meta-llama's tokenizer.py ChatFormat:

  <|begin_of_text|>
  then per message:
    <|start_header_id|>{role}<|end_header_id|>\n\n{content}<|eot_id|>
  then an empty assistant header to cue the model's completion.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Iterator, List


class MessageRole(str, Enum):
    SYSTEM = "system"
    USER = "user"
    ASSISTANT = "assistant"


@dataclass
class Message:
    role: MessageRole
    content: str

    @classmethod
    def system(cls, content: str) -> "Message":
        return cls(MessageRole.SYSTEM, content)

    @classmethod
    def user(cls, content: str) -> "Message":
        return cls(MessageRole.USER, content)

    @classmethod
    def assistant(cls, content: str) -> "Message":
        return cls(MessageRole.ASSISTANT, content)

    @classmethod
    def from_json(cls, obj: dict) -> "Message":
        # serde aliases accepted by the reference REST body (chat.rs:5-38)
        role = obj.get("role") or obj.get("Role")
        content = obj.get("content") or obj.get("Content") or ""
        return cls(MessageRole(role.lower()), content)

    def to_json(self) -> dict:
        return {"role": self.role.value, "content": self.content}


BEGIN_OF_TEXT = "<|begin_of_text|>"
START_HEADER = "<|start_header_id|>"
END_HEADER = "<|end_header_id|>"
EOT = "<|eot_id|>"


TEMPLATES = ("llama3", "mistral", "chatml")


class History:
    """Chat history -> prompt string.

    template="llama3" (default): the reference's format (history.rs:8-33).
    template="mistral": the Mistral-instruct format — `<s>[INST] ...
    [/INST] answer</s>` turns, system prompt merged into the first user
    turn (the official template has no system role), ending after the
    last `[/INST]` to cue completion.
    template="chatml": the Qwen2 format — `<|im_start|>{role}\\n{content}
    <|im_end|>\\n` per message, ending with an open assistant header."""

    def __init__(self, template: str = "llama3") -> None:
        if template not in TEMPLATES:
            raise ValueError(
                f"unknown chat template '{template}' (have {TEMPLATES})")
        self.template = template
        self._messages: List[Message] = []

    def add_message(self, message: Message) -> None:
        self._messages.append(message)

    def clear(self) -> None:
        self._messages.clear()

    def __len__(self) -> int:
        return len(self._messages)

    def __iter__(self) -> Iterator[Message]:
        return iter(self._messages)

    @staticmethod
    def encode_header(role: str) -> str:
        return f"{START_HEADER}{role}{END_HEADER}\n\n"

    @staticmethod
    def encode_message(message: Message) -> str:
        return History.encode_header(message.role.value) + message.content.strip() + EOT

    def render(self) -> str:
        """Full dialog prompt, ending with the template's completion cue."""
        if self.template == "mistral":
            return self._render_mistral()
        if self.template == "chatml":
            out = []
            if not (self._messages
                    and self._messages[0].role == MessageRole.SYSTEM):
                # Qwen2's official template injects this default system
                # prompt when the dialog opens without one
                out.append("<|im_start|>system\n"
                           "You are a helpful assistant.<|im_end|>\n")
            out += [f"<|im_start|>{m.role.value}\n{m.content.strip()}"
                    f"<|im_end|>\n" for m in self._messages]
            out.append("<|im_start|>assistant\n")
            return "".join(out)
        out = [BEGIN_OF_TEXT]
        for m in self._messages:
            out.append(self.encode_message(m))
        out.append(self.encode_header(MessageRole.ASSISTANT.value))
        return "".join(out)

    def _render_mistral(self) -> str:
        out = ["<s>"]
        pending_system: List[str] = []
        for m in self._messages:
            if m.role == MessageRole.SYSTEM:
                # no system role in the template: accumulate (several
                # system messages concatenate) and merge into the next
                # user turn
                pending_system.append(m.content.strip())
            elif m.role == MessageRole.USER:
                text = m.content.strip()
                if pending_system:
                    text = "\n\n".join(pending_system + [text])
                    pending_system = []
                out.append(f"[INST] {text} [/INST]")
            else:
                out.append(f" {m.content.strip()}</s>")
        if pending_system:
            # trailing system with no user turn: render as its own
            # instruction block rather than dropping it silently
            out.append(f"[INST] {chr(10).join(pending_system)} [/INST]")
        return "".join(out)

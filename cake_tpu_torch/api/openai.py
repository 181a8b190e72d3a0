"""OpenAI chat-completions wire shapes.

Counterpart of `cake_tpu/api/openai.py`: request {messages: [{role,
content}]}, response a `chat.completion` object with uuid id, unix
timestamp, single choice; streaming responses use the standard
`chat.completion.chunk` SSE shape.
"""

from __future__ import annotations

import time
import uuid
from typing import List, Optional

from cake_tpu_torch.models.chat import Message


def parse_chat_request(body: dict) -> tuple[List[Message], dict]:
    """Extract messages + generation options from a request body."""
    msgs = [Message.from_json(m) for m in body.get("messages", [])]
    opts = {
        "stream": bool(body.get("stream", False)),
        "max_tokens": body.get("max_tokens"),
        "temperature": body.get("temperature"),
        "top_p": body.get("top_p"),
        "logprobs": bool(body.get("logprobs", False)),
        "top_logprobs": body.get("top_logprobs"),
        # SLO class (interactive | standard | batch); the body's
        # "priority" wins over the x-cake-priority header (the handler
        # merges them)
        "priority": body.get("priority"),
    }
    if opts["priority"] is not None:
        from cake_tpu_torch.sched.classes import validate_priority
        if not isinstance(opts["priority"], str):
            raise ValueError("priority must be a string")
        validate_priority(opts["priority"])   # unknown -> ValueError -> 400
    if opts["top_logprobs"] is not None:
        n = opts["top_logprobs"]
        if (not isinstance(n, int) or isinstance(n, bool)
                or not (0 <= n <= 20)):
            raise ValueError("top_logprobs must be an integer in [0, 20]")
        if not opts["logprobs"]:
            raise ValueError("top_logprobs requires logprobs: true")
    return msgs, opts


def completion_response(text: str, model: str = "cake-tpu",
                        logprobs: list | None = None) -> dict:
    """logprobs: optional [{"token": str, "logprob": float}] content list
    (OpenAI `logprobs: true`; non-streaming responses only)."""
    choice = {
        "index": 0,
        "message": {"role": "assistant", "content": text},
        "finish_reason": "stop",
        # OpenAI schema: logprobs is null unless requested
        "logprobs": ({"content": logprobs}
                     if logprobs is not None else None),
    }
    return {
        "id": str(uuid.uuid4()),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }


def chunk_response(delta: str, model: str = "cake-tpu",
                   finish: Optional[str] = None, rid: str = "",
                   logprobs: Optional[list] = None) -> dict:
    """logprobs: optional list of per-token content entries covering the
    tokens that produced this delta (choices[0].logprobs.content)."""
    return {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "delta": {} if finish else {"content": delta},
            "logprobs": ({"content": logprobs}
                         if logprobs is not None else None),
            "finish_reason": finish,
        }],
    }

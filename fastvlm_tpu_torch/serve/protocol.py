"""Wire protocol shared by the controller, workers and clients.

Counterpart of ``fastvlm_tpu/serve/protocol.py``, unchanged. A stream is
``\\0``-delimited JSON chunks, each carrying the cumulative text and an
error code (the reference workers' envelope, llava/serve/model_worker.py),
so clients behave identically on overload and errors.
"""

from __future__ import annotations

import json

DELIMITER = b"\0"


class ErrorCode:
    OK = 0
    SERVER_ERROR = 1
    OUT_OF_MEMORY = 2
    OVERLOADED = 3
    CLIENT_ERROR = 4


SERVER_ERROR_MSG = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
)


def chunk(text: str, error_code: int = ErrorCode.OK, **extra) -> bytes:
    """One stream chunk: {"text", "error_code", **extra} as JSON + \\0."""
    payload = {"text": text, "error_code": error_code}
    payload.update(extra)
    return json.dumps(payload).encode() + DELIMITER


def iter_chunks(raw_iter):
    """Reassemble \\0-delimited JSON chunks from a byte stream whose pieces
    may split a chunk anywhere."""
    buf = b""
    for piece in raw_iter:
        buf += piece
        while DELIMITER in buf:
            msg, buf = buf.split(DELIMITER, 1)
            if msg:
                yield json.loads(msg.decode())

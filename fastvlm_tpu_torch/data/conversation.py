"""Conversation templates.

Covers the separator styles the reference actually ships models for
(reference llava/conversation.py): ``qwen_2`` (the default for all released
FastVLM checkpoints, conversation.py:407-415, 455), ``plain`` (stage-1
pretraining pairs), ``chatml``/``mpt``, ``v1`` (vicuna), and ``llama_2``.
Rendered strings are byte-identical to the reference for qwen_2/plain/v1 so
tokenizations match released checkpoints.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Optional, Tuple


class SeparatorStyle(Enum):
    QWEN_2 = auto()
    PLAIN = auto()
    CHATML = auto()
    V1 = auto()  # "two" in the reference (vicuna_v1)
    LLAMA_2 = auto()
    MPT = auto()
    SINGLE = auto()  # vicuna_v0 legacy "### Role: msg" style


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    sep_style: SeparatorStyle
    sep: str
    sep2: Optional[str] = None
    version: str = "unknown"

    def append_message(self, role: str, message: Optional[str]) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        s = self.sep_style
        if s == SeparatorStyle.QWEN_2:
            # system<sep> then role+message<sep> per turn; a trailing role with
            # message=None leaves the assistant open (reference
            # conversation.py:67-75).
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if s == SeparatorStyle.PLAIN:
            ret = self.system
            for i, (_, message) in enumerate(self.messages):
                if message:
                    ret += message + (self.sep if i % 2 == 0 else self.sep2)
            return ret
        if s in (SeparatorStyle.CHATML, SeparatorStyle.MPT):
            ret = "" if self.system == "" else self.system + self.sep + "\n"
            if s == SeparatorStyle.MPT:
                ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    if s == SeparatorStyle.CHATML:
                        ret += role + "\n" + message + self.sep + "\n"
                    else:
                        ret += role + message + self.sep
                else:
                    ret += role
            return ret
        if s == SeparatorStyle.V1:
            seps = [self.sep, self.sep2 or self.sep]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                if message:
                    ret += role + ": " + message + seps[i % 2]
                else:
                    ret += role + ":"
            return ret
        if s == SeparatorStyle.SINGLE:
            # legacy vicuna_v0 (reference conversation.py:47-55):
            # system<sep>Role: msg<sep>…; open turn renders "Role:"
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    ret += role + ": " + message + self.sep
                else:
                    ret += role + ":"
            return ret
        if s == SeparatorStyle.LLAMA_2:
            wrap_sys = (lambda m: f"<<SYS>>\n{m}\n<</SYS>>\n\n") if self.system else (lambda m: m)
            ret = ""
            for i, (role, message) in enumerate(self.messages):
                if i == 0 and message:
                    message = wrap_sys(self.system) + message
                if message:
                    if i % 2 == 0:
                        ret += f"{self.sep}[INST] {message} [/INST]"
                    else:
                        ret += f" {message} {self.sep2}"
            return ret.lstrip(self.sep)
        raise ValueError(f"unsupported style {s}")

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )


conv_qwen_2 = Conversation(
    system="<|im_start|>system\nYou are a helpful assistant.",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    messages=[],
    sep_style=SeparatorStyle.QWEN_2,
    sep="<|im_end|>\n",
    version="qwen_v2",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
    version="plain",
)

conv_v1 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.V1,
    sep=" ",
    sep2="</s>",
    version="v1",
)

conv_chatml_direct = Conversation(
    system="<|im_start|>system\nAnswer the questions.",
    roles=("<|im_start|>user", "<|im_start|>assistant"),
    messages=[],
    sep_style=SeparatorStyle.CHATML,
    sep="<|im_end|>",
    version="mpt",
)

conv_llama_2 = Conversation(
    system=(
        "You are a helpful language and vision assistant. You are able to "
        "understand the visual content that the user provides, and assist the "
        "user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
    version="llama_v2",
)

conv_vicuna_v0 = Conversation(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    messages=[],
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0",
)

conv_templates = {
    "qwen_2": conv_qwen_2,
    "plain": conv_plain,
    "v0": conv_vicuna_v0,
    "vicuna_v0": conv_vicuna_v0,
    "v1": conv_v1,
    "vicuna_v1": conv_v1,
    "chatml_direct": conv_chatml_direct,
    "llama_2": conv_llama_2,
}

default_conversation = conv_qwen_2

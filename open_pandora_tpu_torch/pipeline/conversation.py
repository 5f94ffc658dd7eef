"""ChatUniVi conversation templates.

This package's own copy of open_pandora_tpu/pipeline/conversation.py
(framework-free host code): a Conversation state (system prompt, roles,
message list) rendered to a flat prompt string under a separator style. The
world-model session never uses these (it builds its own prompt grammar);
they serve the standalone chat, eval and SFT paths: `v1` (vicuna-style),
`simple`/`simpleqa` (### style), `llama_2` ([INST] style) and `plain`
(caption pretraining pairs).
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import List, Sequence, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


@dataclasses.dataclass
class Conversation:
    """Immutable-by-convention template; `copy()` before mutating."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""
    version: str = "unknown"

    def get_prompt(self) -> str:
        msgs = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, message in msgs:
                if message:
                    out += role + ": " + message + self.sep
                else:
                    out += role + ":"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            out = self.system + seps[0]
            for i, (role, message) in enumerate(msgs):
                if message:
                    out += role + ": " + message + seps[i % 2]
                else:
                    out += role + ":"
            return out
        if self.sep_style == SeparatorStyle.LLAMA_2:
            out = ""
            for i, (role, message) in enumerate(msgs):
                if not message:
                    continue
                if i == 0:
                    message = (f"<<SYS>>\n{self.system}\n<</SYS>>\n\n"
                               + message)
                if i % 2 == 0:
                    out += self.sep + f"[INST] {message} [/INST]"
                else:
                    out += " " + message + " " + self.sep2
            return out.lstrip(self.sep)
        if self.sep_style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            out = self.system
            for i, (_, message) in enumerate(msgs):
                if message:
                    out += message + seps[i % 2]
            return out
        raise ValueError(f"invalid separator style {self.sep_style}")

    def append_message(self, role: str, message: str) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style, sep=self.sep,
            sep2=self.sep2, version=self.version)


conv_v1 = Conversation(
    system=("A chat between a curious user and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the user's questions."),
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

simple_conv = Conversation(
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."),
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "Hi!"],
        ["Assistant", "Hi there! How can I help you today?"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

simple_qa = Conversation(
    system=("A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions.  If you don't know the answer "
            "to a question, please don't share false information."),
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "Is there a snowboard in the image?"],
        ["Assistant", "Yes, there is a snowboard in the image, and the "
                      "person is riding it down a snow-covered slope."],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llama_2 = Conversation(
    system=("You are a helpful language and vision assistant. You are able "
            "to understand the visual content that the user provides, and "
            "assist the user with a variety of tasks using natural "
            "language."),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    version="plain",
    sep="\n",
)

default_conversation = simple_conv
conv_templates = {
    "default": simple_conv,
    "simple": simple_conv,
    "simpleqa": simple_qa,
    "v1": conv_v1,
    "llama_2": conv_llama_2,
    "plain": conv_plain,
}

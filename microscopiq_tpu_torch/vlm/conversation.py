"""Conversation templates for chat prompts.

Own copy of ``microscopiq_tpu/vlm/conversation.py``: the ``Conversation``
dataclass with its separator styles and the templates the serving
front-ends and the VQA evaluation use (vicuna v1 / ``llava_v1``, ``plain``,
the Llama-2 style). Every template's ``get_prompt()`` gives the JAX
package's string for the same messages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()
    PLAIN = enum.auto()
    LLAMA_2 = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[str]]
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = ""

    def append_message(self, role: str, message) -> None:
        self.messages.append([role, message])

    def get_prompt(self) -> str:
        msgs = self.messages
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, msg in msgs:
                ret += role + ": " + (msg + self.sep if msg else "")
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, msg) in enumerate(msgs):
                ret += role + ": " + ((msg + seps[i % 2]) if msg else "")
            return ret
        if self.sep_style == SeparatorStyle.PLAIN:
            ret = self.system
            for i, (_, msg) in enumerate(msgs):
                ret += (msg or "") + ([self.sep, self.sep2][i % 2]
                                      if msg else "")
            return ret
        if self.sep_style == SeparatorStyle.LLAMA_2:
            wrap_sys = (lambda m: f"<<SYS>>\n{m}\n<</SYS>>\n\n"
                        if m else "")
            ret = ""
            for i, (role, msg) in enumerate(msgs):
                if i == 0:
                    msg = wrap_sys(self.system) + (msg or "")
                if i % 2 == 0:
                    ret += f"<s>[INST] {msg} " if msg else "<s>[INST] "
                else:
                    ret += f"{msg} </s>" if msg else ""
            return ret
        raise ValueError(self.sep_style)

    def copy(self) -> "Conversation":
        return Conversation(self.system, self.roles,
                            [[r, m] for r, m in self.messages],
                            self.sep_style, self.sep, self.sep2)


conv_vicuna_v1 = Conversation(
    system=("A chat between a curious human and an artificial "
            "intelligence assistant. The assistant gives helpful, "
            "detailed, and polite answers to the human's questions."),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_llama_2 = Conversation(
    system=("You are a helpful language and vision assistant. You are "
            "able to understand the visual content that the user "
            "provides, and assist the user with a variety of tasks "
            "using natural language."),
    roles=("USER", "ASSISTANT"),
    messages=[],
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_templates = {
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llava_v1": conv_vicuna_v1,
    "plain": conv_llava_plain,
    "llava_llama_2": conv_llava_llama_2,
}

default_conversation = conv_vicuna_v1

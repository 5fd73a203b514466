# A copy of otter_tpu/serve/conversation.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Conversation state + prompt templates for serving/UIs.

Rebuild of `pipeline/serve/conversation.py:17-283`: conversation history
rendered into the model prompt (SINGLE/TWO separator styles) with the otter
template (`otter_v1`, conversation.py:252-260) as default, plus image
handling (downscale bounds, base64 export) used by the web UI flow.
"""

from __future__ import annotations

import base64
import dataclasses
import io
from enum import Enum, auto
from typing import Any, List, Optional, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    IDEFICS = auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[Optional[str], Optional[str]]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    skip_next: bool = False
    conv_id: Any = None

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in self.messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += f"{role}:{message}{self.sep}"
                else:
                    ret += f"{role}:"
            return ret
        if self.sep_style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(self.messages):
                # role labels removed in the reference's TWO style
                # (conversation.py:46)
                if message:
                    if isinstance(message, tuple):
                        message = message[0].strip()
                    ret += message + seps[i % 2]
            return ret
        if self.sep_style == SeparatorStyle.IDEFICS:
            # HF idefics-instruct chat contract (the prompt format the
            # reference's TestIdefics demo and benchmark adapter use):
            # "User:{q}<end_of_utterance>\nAssistant:{a}<end_of_utterance>\n"
            # — an empty assistant message leaves "Assistant:" open for
            # generation. An image placeholder is wrapped in
            # <fake_token_around_image> by the caller.
            ret = self.system
            for role, message in self.messages:
                if message:
                    if isinstance(message, tuple):
                        message = message[0]
                    ret += f"{role}:{message}{self.sep}"
                else:
                    ret += f"{role}:"
            return ret
        raise ValueError(f"invalid style {self.sep_style}")

    def append_message(self, role, message):
        self.messages.append([role, message])

    def get_images(self, *, max_len: int = 1280, min_len: int = 400
                   ) -> List[str]:
        """Collect attached PIL images from user turns as urlsafe base64,
        bounded to [min_len, max_len] on the long side
        (conversation.py:66-115)."""
        from PIL import Image
        out = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 != 0 or not isinstance(msg, (tuple, list)):
                continue
            for image in list(msg)[1:]:
                if image is None:
                    continue
                if isinstance(image, Image.Image):
                    w, h = image.size
                    longest = max(w, h)
                    if longest > max_len:
                        scale = max_len / longest
                        image = image.resize((int(w * scale),
                                              int(h * scale)))
                    buf = io.BytesIO()
                    image.save(buf, format="PNG")
                    out.append(base64.urlsafe_b64encode(
                        buf.getvalue()).decode())
                else:
                    out.append(image)
        return out

    def to_gradio_chatbot(self) -> List[List[Optional[str]]]:
        ret = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            text = msg[0] if isinstance(msg, (tuple, list)) else msg
            if i % 2 == 0:
                ret.append([text, None])
            else:
                ret[-1][-1] = text
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset, sep_style=self.sep_style, sep=self.sep,
            sep2=self.sep2, conv_id=self.conv_id)

    def dict(self) -> dict:
        return {
            "system": self.system, "roles": self.roles,
            "messages": [[r, m[0] if isinstance(m, (tuple, list)) else m]
                         for r, m in self.messages],
            "offset": self.offset, "sep": self.sep, "sep2": self.sep2,
            "conv_id": self.conv_id,
        }


otter_v1 = Conversation(
    system="", roles=("User", "GPT"), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep=" ", sep2="<|endofchunk|></s>")

open_flamingo_v1 = Conversation(
    system="", roles=(None, None), messages=[], offset=0,
    sep_style=SeparatorStyle.TWO, sep="", sep2="</s>")

idefics_instruct = Conversation(
    system="", roles=("User", "Assistant"), messages=[], offset=0,
    sep_style=SeparatorStyle.IDEFICS, sep="<end_of_utterance>\n")

default_conversation = otter_v1
conv_templates = {"otter": otter_v1, "open_flamingo": open_flamingo_v1,
                  "idefics": idefics_instruct}


IDEFICS_IMAGE_PLACEHOLDER = ("<fake_token_around_image><image>"
                             "<fake_token_around_image>")


def render_prompt(template: str, messages: List[List[Optional[str]]],
                  with_image: bool = False) -> str:
    """Multi-turn chat -> model prompt, per family contract.

    messages: [[user_text, assistant_text_or_None], ...]; the last turn's
    assistant side is None (to be generated). The image placeholder goes on
    the FIRST user turn (the reference UIs attach the image to the first
    message, gradio_web_server.py:302-430).

    otter:   "<image>User: {q} GPT:<answer>{a}<|endofchunk|>User: ..."
             (the demo prompt contract, demos/interactive/otter_image.py:52)
    idefics: "User:<fake_token_around_image><image><fake_token_around_image>
             {q}<end_of_utterance>\\nAssistant:{a}<end_of_utterance>\\n..."
    """
    if template == "idefics":
        conv = conv_templates["idefics"].copy()
        for i, (q, a) in enumerate(messages):
            img = IDEFICS_IMAGE_PLACEHOLDER if (with_image and i == 0) else ""
            conv.append_message(conv.roles[0], f"{img}{q}")
            conv.append_message(conv.roles[1], a)
        return conv.get_prompt()
    # otter / open_flamingo style
    parts = []
    for i, (q, a) in enumerate(messages):
        img = "<image>" if (with_image and i == 0) else ""
        turn = f"{img}User: {q} GPT:<answer>"
        if a is not None:
            turn += f"{a}<|endofchunk|>"
        parts.append(turn)
    return "".join(parts)

# A copy of otter_tpu/data/templates.py (the port imports nothing of the JAX package);
# tests/test_torch_serve.py holds its output equal to the original's.
"""Prompt templates and text cleanup for MIMIC-IT.

Exact re-derivation of the reference's text handling
(`pipeline/mimicit_utils/mimicit_dataset.py:276-327`): the four instruction
formats (simple / llama2 / idefics / fuyu) and the pre_question/pre_answer
normalization.
"""

from __future__ import annotations

import re

FLAMINGO_MEAN = (0.481, 0.458, 0.408)
FLAMINGO_STD = (0.269, 0.261, 0.276)
IDEFICS_STANDARD_MEAN = (0.48145466, 0.4578275, 0.40821073)
IDEFICS_STANDARD_STD = (0.26862954, 0.26130258, 0.27577711)

LLAMA2_SYS = ("<<SYS>>\nYou are a helpful vision language assistant. "
              "You are able to understand the visual content. "
              "You need to answer user's questions with plans and Python "
              "codes as response.\n<</SYS>>\n\n")


def pre_question(question: str, keep_symbols: bool = True) -> str:
    if not keep_symbols:
        question = re.sub(r'[^\w\s.,?!()"\']', "", question)
        question = question.strip(" ")
        question = re.sub(r"\s{2,}", " ", question)
        question = question.lstrip("\n").rstrip("\n")
    return question.strip(" ").strip("\n")


def pre_answer(answer: str, keep_symbols: bool = True) -> str:
    answer = answer.strip()
    if not keep_symbols:
        answer = re.sub(r'[^\w\s.,?!()"\']', "", answer)
        answer = re.sub(r"\s{2,}", " ", answer)
        answer = answer.lstrip("\n").rstrip("\n")
    return answer.replace("\r\n", "\n")


def format_pair(instruction: str, answer: str, instruction_format: str,
                *, insert_image: bool = False,
                is_text_only: bool = False) -> str:
    """`process_text_formatting` (mimicit_dataset.py:313-327)."""
    if instruction_format == "llama2":
        placeholder = "" if is_text_only else "<image>"
        prefix = f"[INST]{placeholder}\n" if insert_image else "[INST]"
        return f"{prefix}{instruction}[/INST]<answer>{answer}<|endofchunk|>"
    if instruction_format == "idefics":
        placeholder = ("" if is_text_only else
                       "<fake_token_around_image><image>"
                       "<fake_token_around_image>")
        prefix = f"User:{placeholder}" if insert_image else "User:"
        return (f"{prefix}{instruction}<end_of_utterance>\n"
                f"Assistant:<answer>{answer}<end_of_utterance>\n")
    if instruction_format == "simple":
        placeholder = "" if is_text_only else "<image>"
        prefix = f"{placeholder}User:" if insert_image else "User:"
        return f"{prefix}{instruction} GPT:<answer>{answer}<|endofchunk|>"
    if instruction_format == "fuyu":
        return f"User:{instruction} Assistant:\x04 {answer}"
    raise ValueError(f"unknown instruction_format {instruction_format!r}")


def inference_prompt(question: str, instruction_format: str = "simple",
                     *, insert_image: bool = True) -> str:
    """Prompt contract used by demos/serving
    (`demos/interactive/otter_image.py:52-53`)."""
    if instruction_format == "simple":
        prefix = "<image>" if insert_image else ""
        return f"{prefix}User: {question} GPT:<answer>"
    if instruction_format == "llama2":
        prefix = "[INST]<image>\n" if insert_image else "[INST]"
        return f"{prefix}{question}[/INST]<answer>"
    if instruction_format == "fuyu":
        return f"User:{question} Assistant:\x04"
    raise ValueError(f"unknown instruction_format {instruction_format!r}")

"""Chat-input packing and a streaming text iterator (the port's copy of
``autosmoothquant_tpu/utils/chat.py``; the reference's vendored Baichuan
``generation_utils.py:7-83``). Pure Python over any ``encode`` callable and
role marker token ids."""

from __future__ import annotations

import queue
from typing import Callable, Dict, List, Sequence


def build_chat_input(encode: Callable[[str], List[int]],
                     messages: Sequence[Dict[str, str]],
                     *, model_max_length: int, max_new_tokens: int,
                     user_token_id: int, assistant_token_id: int) -> List[int]:
    """[system] + the newest whole rounds that fit + the assistant marker.
    A round starts at each "user" message; history fills newest first and
    the result is cut on the left to ``model_max_length - max_new_tokens``
    (generation_utils.py:7-50)."""
    system = ""
    rounds: List[List[Dict[str, str]]] = []
    current: List[Dict[str, str]] = []
    for i, message in enumerate(messages):
        if message["role"] == "system":
            if i != 0:
                raise ValueError("the system message must come first")
            system = message["content"]
            continue
        if message["role"] == "user" and current:
            rounds.append(current)
            current = []
        current.append(message)
    if current:
        rounds.append(current)

    max_input_tokens = model_max_length - max_new_tokens
    system_tokens = encode(system) if system else []
    max_history = max_input_tokens - len(system_tokens)

    history: List[int] = []
    for rnd in rounds[::-1]:
        round_tokens: List[int] = []
        for message in rnd:
            marker = (user_token_id if message["role"] == "user"
                      else assistant_token_id)
            round_tokens.append(marker)
            round_tokens.extend(encode(message["content"]))
        if not history or len(history) + len(round_tokens) <= max_history:
            history = round_tokens + history
            if len(history) < max_history:
                continue
        break

    input_tokens = system_tokens + history
    if messages and messages[-1]["role"] != "assistant":
        input_tokens.append(assistant_token_id)
    return input_tokens[-max_input_tokens:]


class TextIterStreamer:
    """Blocking iterator over the text decoded so far, one item a ``put``
    (generation_utils.py:53-83). With ``skip_prompt`` the first ``put`` (the
    prompt) is dropped; ``end`` stops the iteration."""

    def __init__(self, decode: Callable[[List[int]], str],
                 skip_prompt: bool = False):
        self.decode = decode
        self.skip_prompt = skip_prompt
        self.tokens: List[int] = []
        self.text_queue: "queue.Queue" = queue.Queue()
        self._next_is_prompt = True

    def put(self, token_ids: Sequence[int]) -> None:
        if self.skip_prompt and self._next_is_prompt:
            self._next_is_prompt = False
            return
        self.tokens.extend(int(t) for t in token_ids)
        self.text_queue.put(self.decode(self.tokens))

    def end(self) -> None:
        self.text_queue.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> str:
        value = self.text_queue.get()
        if value is None:
            raise StopIteration
        return value

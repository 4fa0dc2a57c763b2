"""The port's conversation templates (``vlm/conversation.py``) against the
JAX package's: every template's ``get_prompt()`` equal, string for string,
for the same messages (an open assistant turn, several turns, an empty
message, a changed system prompt), and ``copy`` independent of the
template."""

import pytest

from microscopiq_tpu.vlm import conversation as jc
from microscopiq_tpu_torch.vlm import conversation as tc

MESSAGES = [
    [("user", "hello")],
    [("user", "<image>\nWhat is in the picture?"), ("assistant", "A cat."),
     ("user", "What colour?")],
    [("user", "")],
    [("user", "one"), ("assistant", "two"), ("user", "three"),
     ("assistant", "four")],
]


@pytest.mark.parametrize("name", sorted(jc.conv_templates))
@pytest.mark.parametrize("msgs", range(len(MESSAGES)))
@pytest.mark.parametrize("system", [None, "Be brief."])
def test_every_template_prompt_equals_jax(name, msgs, system):
    assert sorted(tc.conv_templates) == sorted(jc.conv_templates)
    prompts = []
    for mod in (jc, tc):
        conv = mod.conv_templates[name].copy()
        if system is not None:
            conv.system = system
        for role, text in MESSAGES[msgs]:
            conv.append_message(conv.roles[0 if role == "user" else 1], text)
        conv.append_message(conv.roles[1], None)
        prompts.append(conv.get_prompt())
    assert prompts[0] == prompts[1]
    assert tc.conv_templates[name].messages == []   # copy left it alone
    assert tc.conv_templates[name].sep_style.name == \
        jc.conv_templates[name].sep_style.name
    assert tc.default_conversation.get_prompt() == \
        jc.default_conversation.get_prompt()

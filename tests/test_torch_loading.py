"""The port's HF checkpoint loading (``models/loading.py``) against the JAX
package's: every converter bit-exact on tiny HF state dicts, the
``.safetensors`` reader (written without the ``safetensors`` package)
bit-exact against ``safetensors.numpy`` (F32, F16) and ``safetensors.
torch`` (BF16, which ``safetensors.numpy`` reads only where numpy has a
bfloat16 type), ``.bin`` files, the exports, and the CLI on a tiny local
directory."""

import json

import numpy as np
import pytest
import torch

from microscopiq_tpu.models import loading as jl
from microscopiq_tpu_torch.cli import llm_cli
from microscopiq_tpu_torch.models import loading as tl
from microscopiq_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from microscopiq_tpu_torch.models.opt import OPTConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of a thread a core makes the workers' training and
    matmuls contend for the cores (a 10x slowdown inside the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """transformers reads only local files here."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")


def _hf(kind):
    import transformers as tr

    torch.manual_seed(0)
    if kind == "llama":
        return tr.LlamaForCausalLM(tr.LlamaConfig(
            vocab_size=96, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)).eval()
    if kind == "mixtral":
        return tr.MixtralForCausalLM(tr.MixtralConfig(
            vocab_size=96, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=3,
            max_position_embeddings=64)).eval()
    if kind == "mpt":
        return tr.MptForCausalLM(tr.MptConfig(
            d_model=32, n_heads=4, n_layers=2, vocab_size=96,
            max_seq_len=64)).eval()
    return tr.OPTForCausalLM(tr.OPTConfig(
        vocab_size=96, hidden_size=32, ffn_dim=48, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64)).eval()


CFGS = {
    "llama": lambda L: L(vocab_size=96, hidden_size=32, intermediate_size=48,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, max_position_embeddings=64),
    "mixtral": lambda L: L(vocab_size=96, hidden_size=32,
                           intermediate_size=48, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           num_local_experts=3,
                           max_position_embeddings=64),
    "mpt": lambda L: L.tiny_mpt(vocab_size=96, hidden_size=32,
                                intermediate_size=128, num_attention_heads=4,
                                num_key_value_heads=4),
}


def _assert_tree_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want),
                                  err_msg=path)


@pytest.mark.parametrize("kind", ["llama", "mixtral", "mpt", "opt"])
def test_converters_match_jax_bit_exact(kind):
    from microscopiq_tpu.models import LlamaConfig as JLlama
    from microscopiq_tpu.models import OPTConfig as JOPT

    hf = _hf(kind)
    t_state = tl.state_dict_from_torch_model(hf, device="cpu")
    j_state = jl.state_dict_from_torch_model(hf)
    assert t_state.keys() == j_state.keys()
    for k in t_state:
        assert t_state[k].dtype == torch.float32
        np.testing.assert_array_equal(t_state[k].numpy(), j_state[k])
    if kind == "opt":
        kw = dict(vocab_size=96, hidden_size=32, ffn_dim=48,
                  num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=64)
        got = tl.convert_opt(t_state, OPTConfig(**kw))
        want = jl.convert_opt(j_state, JOPT(**kw))
        back_t = tl.export_opt_state_dict(got, OPTConfig(**kw))
        back_j = jl.export_opt_state_dict(want, JOPT(**kw))
    else:
        conv_t = tl.convert_mpt if kind == "mpt" else tl.convert_llama
        conv_j = jl.convert_mpt if kind == "mpt" else jl.convert_llama
        got = conv_t(t_state, CFGS[kind](LlamaConfig))
        want = conv_j(j_state, CFGS[kind](JLlama))
        back_t = back_j = None
        if kind == "llama":
            back_t = tl.export_llama_state_dict(got, CFGS[kind](LlamaConfig))
            back_j = jl.export_llama_state_dict(want, CFGS[kind](JLlama))
    _assert_tree_equal(got, want)
    if back_t is not None:
        _assert_tree_equal(back_t, back_j)
        for k, v in back_t.items():            # the export inverts the load
            np.testing.assert_array_equal(v.numpy(), t_state[k].numpy())


def _st_tensors():
    g = torch.Generator().manual_seed(1)
    return {"a": torch.randn(3, 5, generator=g),
            "b.weight": torch.randn(7, generator=g),
            "empty": torch.zeros(0, 4), "scalar": torch.randn((), generator=g)}


@pytest.mark.parametrize("dtype", ["F32", "F16"])
def test_safetensors_reader_matches_safetensors_numpy(tmp_path, dtype):
    from safetensors.numpy import load_file, save_file

    npd = {"F32": np.float32, "F16": np.float16}[dtype]
    arrays = {k: v.numpy().astype(npd) for k, v in _st_tensors().items()}
    path = str(tmp_path / "w.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    want = load_file(path)
    got = tl.read_safetensors(path, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    save_file({"ints": np.arange(6, dtype=np.int32)},
              str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        tl.read_safetensors(str(tmp_path / "i.safetensors"),
                            device="cpu")


_NUMPY_ALONE = r"""
import sys
import safetensors.numpy as sn
try:
    sn.load_file(sys.argv[1])
    print("read")
except TypeError as e:
    print("TypeError:", e)
"""


def test_safetensors_bf16_reads_bit_exact_without_numpy_bfloat16(tmp_path):
    """The port reads a BF16 file bit for bit (against safetensors.torch)
    and hands float32 on, in any process. ``safetensors.numpy``, which the
    JAX loader reads through, raises on it in a process where numpy has no
    bfloat16 (no ml_dtypes loaded); in a process that has imported JAX,
    ml_dtypes gives numpy the type and the JAX loader reads it as
    bfloat16, equal to the port's values."""
    import subprocess
    import sys

    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "model.safetensors")
    tensors = {k: v.to(torch.bfloat16) for k, v in _st_tensors().items()}
    save_file(tensors, path)
    want = load_file(path)
    got = tl.read_safetensors(path, device="cpu")
    for k in want:
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16),
                           want[k].view(torch.int16))
    state = tl.load_hf_state_dict(str(tmp_path), device="cpu")
    jstate = jl.load_hf_state_dict(str(tmp_path))
    for k in want:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], want[k].float())
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(jstate[k], np.float32))
    out = subprocess.run([sys.executable, "-c", _NUMPY_ALONE, path],
                         capture_output=True, text=True, timeout=60)
    assert "TypeError:" in out.stdout and "bfloat16" in out.stdout, out


def test_bin_files_load_like_jax(tmp_path):
    tensors = _st_tensors()
    tensors["h"] = tensors["a"].half()
    torch.save(tensors, str(tmp_path / "pytorch_model.bin"))
    got = tl.load_hf_state_dict(str(tmp_path), device="cpu")
    want = jl.load_hf_state_dict(str(tmp_path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    (tmp_path / "sub").mkdir()
    with pytest.raises(FileNotFoundError, match="no safetensors/bin"):
        tl.load_hf_state_dict(str(tmp_path / "sub"), device="cpu")


def test_cli_builds_a_local_hf_directory_like_jax(tmp_path):
    """A tiny HF Llama saved to a directory (config.json + safetensors):
    the port's CLI builds the same config and weights as the JAX CLI, the
    model's logits equal HF's, and the CLI runs its perplexity on it."""
    from microscopiq_tpu.cli import llm_cli as j_cli

    hf = _hf("llama")
    hf.save_pretrained(str(tmp_path), safe_serialization=True)
    assert json.loads((tmp_path / "config.json").read_text())[
        "architectures"] == ["LlamaForCausalLM"]
    kind, cfg, cls, params, tok = llm_cli.build_model(str(tmp_path), "cpu")
    jkind, jcfg, _, jparams, jtok = j_cli.build_model(str(tmp_path))
    assert kind == jkind == "llama" and tok is None and jtok is None
    for f in ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "max_position_embeddings",
              "rope_theta", "rms_norm_eps", "sliding_window",
              "num_local_experts", "tie_word_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    _assert_tree_equal(params, jparams)
    model = cls(cfg, device="cpu").load_params(params)
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 96, (2, 10)))
    with torch.no_grad():
        torch.testing.assert_close(model(ids), hf(ids).logits, rtol=2e-3,
                                   atol=2e-3)
    ppl = llm_cli.main([str(tmp_path), "synthetic", "--nsamples", "2",
                        "--seqlen", "32", "--no-quant", "--allow-synthetic",
                        "--device", "cpu"])
    assert np.isfinite(ppl)

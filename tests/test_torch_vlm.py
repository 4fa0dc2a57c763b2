"""The port's LLaVA stack (microscopiq_tpu_torch.vlm) against the JAX
package's on the same weights, tiny configs on the CPU: JAX initializes the
weights (flax initializers, PRNGKey 0), they cross to the port by
convert.params_from_jax, and both models run the same numpy inputs. The JAX
model runs with use_pallas=False, which routes packed weights to
dequant_matmul_reference, as the JAX tests run it.

Tolerances:
- bit-exact: splice_image_features, the converted HF trees (CLIP, the
  projector, the Llama and MPT LLaVA layouts), pack_llava_lm's codes;
- rtol=2e-5, atol=1e-4 (the repo's matmul tolerance,
  tests/test_pallas_kernels.py:68): the tower, the projector, the tiny
  LLaVA's float32 logits, dense and packed (the same float32 algorithm;
  XLA and torch sum in other orders, measured <= 3e-7 here);
- greedy tokens equal: generate_mm over the dense and the 4-bit caches;
- llava_sequential: >= 95% of each quantized kernel's entries equal to
  JAX's, the share tests/test_torch_gptq.py holds GPTQ to (the two
  Cholesky factorizations round differently); the tower, projector,
  embedding, norms and lm_head bit-unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microscopiq_tpu import vlm as jvlm
from microscopiq_tpu.ops import packing as jpk
from microscopiq_tpu.specs import finalize_mx_specs as j_specs
from microscopiq_tpu.vlm import llava as jllava
from microscopiq_tpu_torch import vlm
from microscopiq_tpu_torch.convert import params_from_jax
from microscopiq_tpu_torch.specs import finalize_mx_specs
from microscopiq_tpu_torch.vlm import llava

RTOL, ATOL = 2e-5, 1e-4
SPECS = {"w_elem_format": "fp6_e3m2", "scale_bits": 8, "block_size": 32}


def jax_to_numpy(tree):
    """JAX tree -> numpy leaves; PackedMX -> the dict params_from_jax
    takes."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, jpk.PackedMX):
        return {f.name: (np.asarray(getattr(tree, f.name))
                         if f.name in ("codes", "scale_exp")
                         else getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    return np.asarray(tree)


def to_port(params):
    return params_from_jax(jax_to_numpy(params), device="cpu")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def prompt(cfg, B=1, S=24, seed=0):
    """ids (image slots zeroed), mask (slots 3..3+T), NHWC pixels."""
    rng = np.random.default_rng(seed)
    T = cfg.num_image_tokens
    ids = rng.integers(3, cfg.text.vocab_size, (B, S)).astype(np.int32)
    mask = np.zeros((B, S), bool)
    mask[:, 3:3 + T] = True
    ids[mask] = 0
    pix = rng.normal(size=(B, cfg.vision.image_size, cfg.vision.image_size,
                           3)).astype(np.float32)
    return ids, mask, pix


@functools.lru_cache(maxsize=None)
def jax_pair(name="tiny", packed=False):
    """(JAX model, JAX params) of the tiny config ``name``: a jitted init
    at PRNGKey 0, the language model packed by a jitted pack_llava_lm
    (jit and eager JAX give the same codes: checked when this test was
    written, the eager pack takes ~15 s)."""
    jcfg = getattr(jvlm.LlavaConfig, name)()
    jm = jvlm.LlavaForCausalLM(jcfg, use_pallas=False)
    if packed:
        specs = j_specs(dict(SPECS))
        return jm, jax.jit(lambda p: jllava.pack_llava_lm(p, specs))(
            jax_pair(name)[1])
    ids, mask, pix = prompt(jcfg)
    params = jax.jit(lambda k, i, m, x: jm.init(
        k, i, pixel_values=x, image_token_mask=m))(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(pix))
    return jm, params


def pair(name="tiny", packed=False):
    """(JAX model, JAX params, port model, port config) on one JAX init."""
    jm, params = jax_pair(name, packed)
    tcfg = getattr(vlm.LlavaConfig, name)()
    tm = vlm.LlavaForCausalLM(tcfg, device="cpu").load_params(
        to_port(params))
    return jm, params, tm, tcfg


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_splice_image_features_is_bit_exact():
    rng = np.random.default_rng(0)
    B, S, T, D = 3, 11, 4, 5
    text = rng.normal(size=(B, S, D)).astype(np.float32)
    img = rng.normal(size=(B, T, D)).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[0, 1:5] = True
    mask[1, [0, 3, 6, 10]] = True
    mask[2, 7:] = True
    want = np.asarray(jllava.splice_image_features(
        jnp.asarray(text), jnp.asarray(img), jnp.asarray(mask)))
    got = llava.splice_image_features(_t(text), _t(img), _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    for b in range(B):
        np.testing.assert_array_equal(got[b, mask[b]], img[b])
        np.testing.assert_array_equal(got[b, ~mask[b]], text[b, ~mask[b]])


@pytest.mark.parametrize("feature,layer", [("patch", -2), ("patch", -1),
                                           ("cls_patch", -2),
                                           ("cls_patch", -1)])
def test_vision_tower_matches_jax(feature, layer):
    cfg = jvlm.CLIPVisionConfig.tiny()
    jt = jvlm.CLIPVisionTower(cfg, select_layer=layer,
                              select_feature=feature)
    pix = np.random.default_rng(2).normal(size=(2, 16, 16, 3)
                                          ).astype(np.float32)
    params = jt.init(jax.random.PRNGKey(1), jnp.asarray(pix))
    want = np.asarray(jt.apply(params, jnp.asarray(pix)))
    tt = vlm.CLIPVisionTower(vlm.CLIPVisionConfig.tiny(), layer, feature)
    from microscopiq_tpu_torch.models.llama import install_tree

    install_tree(tt, to_port(params["params"]), torch.device("cpu"))
    with torch.no_grad():
        got = tt(_t(pix)).numpy()
    assert got.shape == want.shape == (
        2, cfg.num_patches + (feature == "cls_patch"), cfg.hidden_size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vision_tower_rejects_unknown_feature_and_ragged_images():
    from microscopiq_tpu_torch.models.llama import install_tree

    cfg = vlm.CLIPVisionConfig.tiny()
    jt = jvlm.CLIPVisionTower(jvlm.CLIPVisionConfig.tiny())
    params = jt.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))
    tt = vlm.CLIPVisionTower(cfg, select_feature="cls")
    install_tree(tt, to_port(params["params"]), torch.device("cpu"))
    with pytest.raises(ValueError, match="select_feature"):
        tt(torch.zeros(1, 16, 16, 3))
    tt.select_feature = "patch"
    with pytest.raises(ValueError, match="multiple of the patch"):
        tt(torch.zeros(1, 12, 16, 3))


@pytest.mark.parametrize("ptype", ["identity", "linear", "mlp2x_gelu",
                                   "mlp3x_gelu"])
def test_projector_matches_jax(ptype):
    jp = jvlm.VisionProjector(24, ptype)
    x = np.random.default_rng(3).normal(size=(2, 5, 16)).astype(np.float32)
    params = jp.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jp.apply(params, jnp.asarray(x)))
    tp = vlm.VisionProjector(24, ptype)
    from microscopiq_tpu_torch.models.llama import install_tree

    install_tree(tp, to_port(params.get("params", {})), torch.device("cpu"))
    with torch.no_grad():
        got = tp(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown projector"):
        vlm.VisionProjector(24, "mlp_gelu")


def _packed_inputs(inter, params, tm, ids, mask, pix):
    """Each packed linear's input in the two packages, in the port's
    execution order: {name: (the port's input, JAX's input, the port's
    module)}; JAX's from its 'intermediates' ``inter`` (the gptq_input
    sow)."""
    from microscopiq_tpu_torch.models.llama import QLinear

    jx = {".".join(p for p in path if p != "gptq_input"
                   and not p.isdigit()): leaf
          for path, leaf in leaves(jax_to_numpy(inter["intermediates"]))}
    got, mods, hooks = {}, {}, []
    for name, mod in tm.named_modules():
        if isinstance(mod, QLinear) and hasattr(mod.kernel, "codes"):
            key = name.replace("layers.", "layers_")
            mods[key] = mod
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, key=key: got.__setitem__(key, i[0])))
    with torch.no_grad():
        tm(_t(ids).long(), pixel_values=_t(pix), image_token_mask=_t(mask))
    for h in hooks:
        h.remove()
    n_packed = sum(path[-1] == "codes"
                   for path, _ in leaves(jax_to_numpy(params)))
    assert len(got) == n_packed and set(got) <= set(jx)
    return {key: (x, jx[key].reshape(x.shape), mods[key])
            for key, x in got.items()}


def _packed_linears_match_jax(params, inputs):
    """Every packed linear of the port, fed JAX's own input, against JAX's
    dequant_matmul_reference on that input and JAX's packed kernel, at
    rtol/atol."""
    from microscopiq_tpu.ops.pallas import dequant_matmul_reference

    for key, (_, xj, mod) in inputs.items():
        node = params["params"]
        for part in key.split("."):
            node = node[part]
        with torch.no_grad():
            got = mod(_t(xj)).float().numpy()
        want = np.asarray(dequant_matmul_reference(
            jnp.asarray(xj), node["kernel"], out_dtype=jnp.float32))
        if "bias" in node:
            want = want + np.asarray(node["bias"])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def _first_bf16_flip(inputs):
    """The first packed linear, in execution order, whose input rounds to
    another bfloat16 in the two packages (the kernels' twins round x to
    bf16 before the dot): (its name, the elements that flip, the float32
    input's error there relative to max |input|), or None."""
    for key, (x, want, _) in inputs.items():
        flips = int((x.to(torch.bfloat16) != _t(want).to(
            torch.bfloat16)).sum())
        if flips:
            return key, flips, float(np.abs(x.numpy() - want).max()
                                     / np.abs(want).max())
    return None


# the packed cases whose logits miss rtol/atol against JAX because one
# packed linear's input rounds to another bfloat16 in the two packages
# (its float32 values within RTOL of max), while every packed linear,
# fed JAX's own input, agrees with JAX at rtol/atol (ROADMAP queue 3):
# {case: (the first such linear, the elements whose rounding flips)}
KNOWN_FLIPS = {"tiny_mistral": ("model.layers_0.mlp.down_proj", 1)}


@pytest.mark.parametrize("name,packed", [
    ("tiny", False), ("tiny", True), ("tiny_mistral", False),
    ("tiny_mistral", True), ("tiny_mpt", False), ("tiny_mpt", True)])
def test_llava_logits_match_jax(name, packed):
    """Every logit within rtol/atol of JAX's. Packed: also every packed
    linear, fed JAX's own input, within rtol/atol of JAX's; and the one
    case of KNOWN_FLIPS, where the first flipped bf16 rounding must be the
    named linear with its element count, may miss rtol/atol in at most
    0.2% of its logits, each within 2^-8 of max |logit|."""
    jm, params, tm, cfg = pair(name, packed)
    ids, mask, pix = prompt(cfg, B=2, seed=5)
    want, inter = jax.jit(lambda p, i, m, x: jm.apply(
        p, i, pixel_values=x, image_token_mask=m,
        mutable=["intermediates"]))(
        params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pix))
    want = np.asarray(want)
    with torch.no_grad():
        got = tm(_t(ids).long(), pixel_values=_t(pix),
                 image_token_mask=_t(mask)).numpy()
        last = tm(_t(ids).long(), pixel_values=_t(pix),
                  image_token_mask=_t(mask), last_only=True).numpy()
    assert got.shape == want.shape == (2, 24, cfg.text.vocab_size)
    np.testing.assert_allclose(last[:, 0], got[:, -1], rtol=RTOL, atol=ATOL)
    if cfg.text.tie_word_embeddings:
        assert tm.lm_head is None and "lm_head" not in params["params"]
    if packed:
        inputs = _packed_inputs(inter, params, tm, ids, mask, pix)
        _packed_linears_match_jax(params, inputs)
    miss = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    if not (packed and name in KNOWN_FLIPS and miss.any()):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        return
    first = _first_bf16_flip(inputs)
    assert first is not None and first[:2] == KNOWN_FLIPS[name], first
    assert first[2] <= RTOL, first
    assert miss.mean() <= 2e-3, miss.mean()
    assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


def test_pack_llava_lm_codes_are_jax_s():
    """The port packs the same dense tree to JAX's codes bit for bit, and
    only the language model: tower, projector and lm_head stay dense."""
    _, params, _, _ = pair("tiny")
    jpacked = jax_to_numpy(jax_pair("tiny", True)[1])

    tpacked = llava.pack_llava_lm(to_port(params),
                                  finalize_mx_specs(dict(SPECS)))
    jl, tl = dict(leaves(jpacked)), dict(leaves(tpacked))
    n_packed = 0
    for path, t in tl.items():
        if hasattr(t, "codes"):
            n_packed += 1
            assert path[1] == "model"
            for f in ("codes", "scale_exp"):
                np.testing.assert_array_equal(
                    getattr(t, f).numpy(), jl[path + (f,)])
        else:
            np.testing.assert_array_equal(t.numpy(), jl[path])
    assert n_packed == 2 * 7


def test_llava_image_sensitivity_text_only_and_mask_check():
    _, _, tm, cfg = pair("tiny")
    ids, mask, pix = prompt(cfg)
    ids_t = _t(ids).long()
    with torch.no_grad():
        a = tm(ids_t, pixel_values=_t(pix), image_token_mask=_t(mask))
        b = tm(ids_t, pixel_values=_t(pix * 2), image_token_mask=_t(mask))
        c = tm(ids_t)
    assert not torch.allclose(a[:, -1], b[:, -1])
    assert c.shape == a.shape
    with pytest.raises(ValueError, match="image_token_mask"):
        tm(ids_t, pixel_values=_t(pix))


def test_inputs_embeds_and_multimodal_hidden_match_jax():
    """``inputs_embeds`` replaces the embedding, and multimodal_hidden
    (llava_sequential's layer-0 input) equals JAX's."""
    jm, params, tm, cfg = pair("tiny")
    jcfg = jm.cfg
    ids, mask, pix = prompt(cfg, B=2, seed=7)
    want = np.asarray(jllava.multimodal_hidden(
        jcfg, params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pix),
        use_pallas=False))
    got = llava.multimodal_hidden(cfg, to_port(params), ids, mask, pix)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    jl = np.asarray(jm.apply(params, jnp.asarray(ids),
                             inputs_embeds=jnp.asarray(want)))
    with torch.no_grad():
        tl = tm(None, inputs_embeds=got).numpy()
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)


def _hf_llava_state(cfg, mpt=False, seed=0):
    """A synthetic HF LLaVA state dict (numpy) of the tiny config: the LM in
    the Llama or MPT layout, the CLIP tower and a 2-linear projector."""
    rng = np.random.default_rng(seed)
    tc, vc = cfg.text, cfg.vision
    D, I, V = tc.hidden_size, tc.intermediate_size, tc.vocab_size
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    sd = {}
    if mpt:
        base = "transformer"
        sd["transformer.wte.weight"] = r(V, D)
        for i in range(tc.num_hidden_layers):
            p = f"transformer.blocks.{i}."
            sd[p + "attn.Wqkv.weight"] = r(3 * D, D)
            sd[p + "attn.out_proj.weight"] = r(D, D)
            sd[p + "norm_1.weight"] = r(D)
            sd[p + "norm_2.weight"] = r(D)
            sd[p + "ffn.up_proj.weight"] = r(I, D)
            sd[p + "ffn.down_proj.weight"] = r(D, I)
        sd["transformer.norm_f.weight"] = r(D)
    else:
        base = "model"
        hd = tc.head_dim
        sd["model.embed_tokens.weight"] = r(V, D)
        for i in range(tc.num_hidden_layers):
            p = f"model.layers.{i}."
            for n, o in (("q", tc.num_attention_heads * hd),
                         ("k", tc.num_key_value_heads * hd),
                         ("v", tc.num_key_value_heads * hd)):
                sd[p + f"self_attn.{n}_proj.weight"] = r(o, D)
            sd[p + "self_attn.o_proj.weight"] = r(D, D)
            sd[p + "mlp.gate_proj.weight"] = r(I, D)
            sd[p + "mlp.up_proj.weight"] = r(I, D)
            sd[p + "mlp.down_proj.weight"] = r(D, I)
            sd[p + "input_layernorm.weight"] = r(D)
            sd[p + "post_attention_layernorm.weight"] = r(D)
        sd["model.norm.weight"] = r(D)
        sd["lm_head.weight"] = r(V, D)
    vp = f"{base}.vision_tower.vision_tower.vision_model."
    Dv, Iv, ps = vc.hidden_size, vc.intermediate_size, vc.patch_size
    sd[vp + "embeddings.class_embedding"] = r(Dv)
    sd[vp + "embeddings.position_embedding.weight"] = r(vc.num_positions, Dv)
    sd[vp + "embeddings.patch_embedding.weight"] = r(Dv, 3, ps, ps)
    sd[vp + "pre_layrnorm.weight"] = r(Dv)
    sd[vp + "pre_layrnorm.bias"] = r(Dv)
    for i in range(vc.num_hidden_layers):
        p = vp + f"encoder.layers.{i}."
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[p + f"self_attn.{n}.weight"] = r(Dv, Dv)
            sd[p + f"self_attn.{n}.bias"] = r(Dv)
        sd[p + "mlp.fc1.weight"] = r(Iv, Dv)
        sd[p + "mlp.fc1.bias"] = r(Iv)
        sd[p + "mlp.fc2.weight"] = r(Dv, Iv)
        sd[p + "mlp.fc2.bias"] = r(Dv)
        for n in ("layer_norm1", "layer_norm2"):
            sd[p + f"{n}.weight"] = r(Dv)
            sd[p + f"{n}.bias"] = r(Dv)
    sd[f"{base}.mm_projector.0.weight"] = r(D, Dv)
    sd[f"{base}.mm_projector.0.bias"] = r(D)
    sd[f"{base}.mm_projector.2.weight"] = r(D, D)
    sd[f"{base}.mm_projector.2.bias"] = r(D)
    return sd


@pytest.mark.parametrize("name,mpt", [("tiny", False), ("tiny_mpt", True)])
def test_convert_hf_llava_is_bit_exact(name, mpt):
    jcfg = getattr(jvlm.LlavaConfig, name)()
    tcfg = getattr(vlm.LlavaConfig, name)()
    sd = _hf_llava_state(jcfg, mpt)
    want = dict(leaves(jax_to_numpy(jvlm.convert_hf_llava(sd, jcfg))))
    for src in (sd, {k: torch.as_tensor(v) for k, v in sd.items()}):
        got = dict(leaves(vlm.convert_hf_llava(src, tcfg)))
        assert set(got) == set(want)
        for path, t in got.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), want[path])
    # the converted tree runs: both packages give the same logits
    tree = vlm.convert_hf_llava(sd, tcfg)
    tm = vlm.LlavaForCausalLM(tcfg, device="cpu").load_params(tree)
    jm = jvlm.LlavaForCausalLM(jcfg, use_pallas=False)
    ids, mask, pix = prompt(tcfg, seed=17)
    jl = np.asarray(jm.apply(jvlm.convert_hf_llava(sd, jcfg),
                             jnp.asarray(ids), pixel_values=jnp.asarray(pix),
                             image_token_mask=jnp.asarray(mask)))
    with torch.no_grad():
        tl = tm(_t(ids).long(), pixel_values=_t(pix),
                image_token_mask=_t(mask)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-3 * np.abs(
        jl).max())


def test_convert_hf_clip_and_projector_alone_are_bit_exact():
    from microscopiq_tpu.vlm.clip import convert_hf_clip_vision as j_clip
    from microscopiq_tpu.vlm.projector import convert_hf_projector as j_proj
    from microscopiq_tpu_torch.vlm.clip import convert_hf_clip_vision
    from microscopiq_tpu_torch.vlm.projector import convert_hf_projector

    jcfg = jvlm.LlavaConfig.tiny()
    sd = _hf_llava_state(jcfg)
    pre = "model.vision_tower.vision_tower.vision_model."
    want = dict(leaves(jax_to_numpy(j_clip(sd, jcfg.vision, prefix=pre))))
    got = dict(leaves(convert_hf_clip_vision(
        sd, vlm.CLIPVisionConfig.tiny(), prefix=pre)))
    assert set(got) == set(want)
    for p, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[p])
    want = dict(leaves(jax_to_numpy(j_proj(sd))))
    got = dict(leaves(convert_hf_projector(sd)))
    assert set(got) == set(want) and len(got) == 4
    for p, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[p])
    with pytest.raises(KeyError):
        convert_hf_projector({}, "linear")
    assert convert_hf_projector({}, "identity") == {}


def test_configs_match_jax():
    for name in ("tiny", "tiny_mistral", "tiny_mpt", "mistral", "mpt"):
        j = getattr(jvlm.LlavaConfig, name)()
        t = getattr(vlm.LlavaConfig, name)()
        assert j.num_image_tokens == t.num_image_tokens
        for f in dataclasses.fields(j.text):
            if f.name != "dtype":
                assert getattr(j.text, f.name) == getattr(t.text, f.name), \
                    (name, f.name)
        assert dataclasses.asdict(j.vision).keys() == \
            dataclasses.asdict(t.vision).keys()
    j, t = jvlm.LlavaConfig(), vlm.LlavaConfig()
    assert (t.num_image_tokens, t.vision.num_positions) == (576, 577)
    assert j.num_image_tokens == t.num_image_tokens
    assert (t.text.hidden_size, t.text.num_hidden_layers,
            t.text.vocab_size) == (4096, 32, 32000)
    assert vlm.LlavaConfig.tiny(
        vision_select_feature="cls_patch").num_image_tokens == 5


def test_port_vlm_exports_every_name_of_jax():
    assert set(jvlm.__all__) <= set(vlm.__all__)
    for name in jvlm.__all__:
        assert getattr(vlm, name) is not None


@pytest.mark.parametrize("packed", [False, True])
def test_params_from_jax_carries_the_whole_llava_tree(packed):
    """Every leaf of a JAX LLaVA tree (tower with the conv kernel in flax's
    (kh, kw, in, out) layout, projector, dense or packed language model,
    lm_head) crosses bit for bit; no leaf is transposed."""
    _, params = jax_pair("tiny", packed)
    want = dict(leaves(jax_to_numpy(params)))
    got = {}
    for path, t in leaves(to_port(params)):
        if hasattr(t, "codes"):
            for f in ("codes", "scale_exp"):
                got[path + (f,)] = getattr(t, f).numpy()
        else:
            got[path] = t.numpy()
    assert set(got) <= set(want)
    for path, a in got.items():
        np.testing.assert_array_equal(a, want[path])
    kernel = ("params", "vision_tower", "vision_model", "patch_embedding",
              "kernel")
    assert got[kernel].shape == (8, 8, 3, 32)
    assert any(hasattr(t, "codes") for _, t in leaves(to_port(params))) \
        == packed

"""Checkpoint, delta and camera loaders of the port (io/) vs the JAX
package's: the safetensors reader against the ``safetensors`` package, the
four sgm converters against ``from_jax_params(JAX converter)`` on the state
dicts tests/test_io.py builds (exactly: same tree, same values), the delta
npz/torch formats and ``apply_delta_state_dict``, and the cameras npz."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.io import cameras_io as jcio
from custom_diffusion360_tpu.io import delta as jdelta
from custom_diffusion360_tpu.io import torch_convert as jconv
from custom_diffusion360_tpu.models.clip import ClipTextConfig as JClipCfg
from custom_diffusion360_tpu.models.clip import init_clip_text_params
from custom_diffusion360_tpu.models.unet import UNetConfig as JUNetCfg, init_unet_params
from custom_diffusion360_tpu.models.vae import VAEConfig as JVAECfg, init_vae_params
from custom_diffusion360_torch.io import cameras_io as tcio
from custom_diffusion360_torch.io import delta as tdelta
from custom_diffusion360_torch.io import torch_convert as tconv
from custom_diffusion360_torch.io.safetensors import load_safetensors
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from tests.test_cameras import random_cameras
from tests.test_io import _conv_sd, _lin_sd, _norm_sd, make_unet_sd
from tests.test_torch_common import TINY_UNET, TINY_VAE, random_params, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

CLIP_KW = dict(vocab_size=32, width=16, layers=2, heads=2, context_length=8)
OPEN_KW = dict(CLIP_KW, act="gelu", text_projection=True)


def assert_same_tree(got, want):
    """Same nesting and keys, each leaf equal in shape, dtype and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_tree(a, b)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)


def _vae_sd(params, n_lv):
    sd, P = {}, "first_stage_model."

    def res(prefix, p):
        _norm_sd(sd, prefix + ".norm1", p["norm1"])
        _conv_sd(sd, prefix + ".conv1", p["conv1"])
        _norm_sd(sd, prefix + ".norm2", p["norm2"])
        _conv_sd(sd, prefix + ".conv2", p["conv2"])
        if "nin_shortcut" in p:
            _conv_sd(sd, prefix + ".nin_shortcut", p["nin_shortcut"])

    def attn(prefix, p):
        _norm_sd(sd, prefix + ".norm", p["norm"])
        for n in ("q", "k", "v", "proj_out"):
            _conv_sd(sd, f"{prefix}.{n}", p[n])

    for part in ("encoder", "decoder"):
        tree = params[part]
        _conv_sd(sd, f"{P}{part}.conv_in", tree["conv_in"])
        res(f"{P}{part}.mid.block_1", tree["mid"]["block_1"])
        attn(f"{P}{part}.mid.attn_1", tree["mid"]["attn_1"])
        res(f"{P}{part}.mid.block_2", tree["mid"]["block_2"])
        _norm_sd(sd, f"{P}{part}.norm_out", tree["norm_out"])
        _conv_sd(sd, f"{P}{part}.conv_out", tree["conv_out"])
        for i in range(n_lv):
            lvl = tree[f"down_{i}" if part == "encoder" else f"up_{i}"]
            name = "down" if part == "encoder" else "up"
            for j, bp in enumerate(lvl["block"]):
                res(f"{P}{part}.{name}.{i}.block.{j}", bp)
            for sub in ("downsample", "upsample"):
                if sub in lvl:
                    _conv_sd(sd, f"{P}{part}.{name}.{i}.{sub}.conv", lvl[sub])
    _conv_sd(sd, P + "quant_conv", params["quant_conv"])
    _conv_sd(sd, P + "post_quant_conv", params["post_quant_conv"])
    return sd


def _clip_l_sd(params, cfg, extra_rows=True):
    sd, P = {}, "conditioner.embedders.0.transformer.text_model."
    table = [np.asarray(params["token_embedding"])]
    if extra_rows:
        table.append(np.asarray(params["modifier_rows"]))
    sd[P + "embeddings.token_embedding.weight"] = np.concatenate(table)
    sd[P + "embeddings.position_embedding.weight"] = np.asarray(params["positional_embedding"])
    _norm_sd(sd, P + "final_layer_norm", params["ln_final"])
    for i in range(cfg.layers):
        bp = jax.tree.map(lambda x: x[i], params["blocks"])
        lp = f"{P}encoder.layers.{i}."
        _norm_sd(sd, lp + "layer_norm1", bp["ln1"])
        _norm_sd(sd, lp + "layer_norm2", bp["ln2"])
        for ours, theirs in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"), ("o", "self_attn.out_proj"),
                             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _lin_sd(sd, lp + theirs, bp[ours])
    return sd


def _open_clip_sd(params, cfg):
    sd, P = {}, "conditioner.embedders.1.model."
    sd[P + "token_embedding.weight"] = np.concatenate(
        [np.asarray(params["token_embedding"]), np.asarray(params["modifier_rows"])])
    sd[P + "positional_embedding"] = np.asarray(params["positional_embedding"])
    _norm_sd(sd, P + "ln_final", params["ln_final"])
    sd[P + "text_projection"] = np.asarray(params["text_projection"]["w"])
    for i in range(cfg.layers):
        bp = jax.tree.map(lambda x: x[i], params["blocks"])
        lp = f"{P}transformer.resblocks.{i}."
        _norm_sd(sd, lp + "ln_1", bp["ln1"])
        _norm_sd(sd, lp + "ln_2", bp["ln2"])
        sd[lp + "attn.in_proj_weight"] = np.concatenate(
            [np.asarray(bp[k]["w"]).T for k in ("q", "k", "v")])
        sd[lp + "attn.in_proj_bias"] = np.concatenate([np.asarray(bp[k]["b"]) for k in "qkv"])
        _lin_sd(sd, lp + "attn.out_proj", bp["o"])
        _lin_sd(sd, lp + "mlp.c_fc", bp["fc1"])
        _lin_sd(sd, lp + "mlp.c_proj", bp["fc2"])
    return sd


@pytest.fixture(scope="module")
def sgm_sd():
    """One sgm-layout state dict holding a TINY UNet, VAE and both towers."""
    p_unet = random_params(lambda k: init_unet_params(k, JUNetCfg(**TINY_UNET)), seed=1)
    p_vae = random_params(lambda k: init_vae_params(k, JVAECfg(**TINY_VAE)), seed=2)
    p_l = random_params(lambda k: init_clip_text_params(k, JClipCfg(**CLIP_KW)), seed=3)
    p_g = random_params(lambda k: init_clip_text_params(k, JClipCfg(**OPEN_KW)), seed=4)
    sd = {**make_unet_sd(p_unet, JUNetCfg(**TINY_UNET)), **_vae_sd(p_vae, len(TINY_VAE["ch_mult"])),
          **_clip_l_sd(p_l, JClipCfg(**CLIP_KW)), **_open_clip_sd(p_g, JClipCfg(**OPEN_KW))}
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}, p_l


def _jax_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("which", ["unet", "vae", "clip_l", "open_clip"])
def test_converters_match_jax_exactly(sgm_sd, which):
    sd, _ = sgm_sd
    conv = {
        "unet": (lambda m: m.convert_unet_state_dict, JUNetCfg(**TINY_UNET),
                 UNetConfig(**TINY_UNET)),
        "vae": (lambda m: m.convert_vae_state_dict, JVAECfg(**TINY_VAE), VAEConfig(**TINY_VAE)),
        "clip_l": (lambda m: m.convert_clip_l_state_dict, JClipCfg(**CLIP_KW),
                   ClipTextConfig(**CLIP_KW)),
        "open_clip": (lambda m: m.convert_open_clip_state_dict, JClipCfg(**OPEN_KW),
                      ClipTextConfig(**OPEN_KW)),
    }[which]
    want = to_torch(_jax_np(conv[0](jconv)(sd, conv[1])))
    got = conv[0](tconv)({k: torch.from_numpy(v) for k, v in sd.items()}, conv[2])
    assert_same_tree(got, want)


def test_clip_without_appended_rows_gets_zero_modifier_rows(sgm_sd):
    _, p_l = sgm_sd
    sd = {k: np.asarray(v, np.float32)
          for k, v in _clip_l_sd(p_l, JClipCfg(**CLIP_KW), extra_rows=False).items()}
    want = to_torch(_jax_np(jconv.convert_clip_l_state_dict(sd, JClipCfg(**CLIP_KW))))
    got = tconv.convert_clip_l_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                          ClipTextConfig(**CLIP_KW))
    assert_same_tree(got, want)
    assert not got["modifier_rows"].any()


def test_load_sdxl_checkpoint_matches_jax(sgm_sd, tmp_path):
    from safetensors.numpy import save_file

    sd, _ = sgm_sd
    path = str(tmp_path / "base.safetensors")
    save_file(sd, path)
    cfgs_j = (JUNetCfg(**TINY_UNET), JVAECfg(**TINY_VAE), JClipCfg(**CLIP_KW), JClipCfg(**OPEN_KW))
    cfgs_t = (UNetConfig(**TINY_UNET), VAEConfig(**TINY_VAE), ClipTextConfig(**CLIP_KW),
              ClipTextConfig(**OPEN_KW))
    want = to_torch(_jax_np(jconv.load_sdxl_checkpoint(path, *cfgs_j)))
    assert_same_tree(tconv.load_sdxl_checkpoint(path, *cfgs_t), want)
    # the same state dict as a torch checkpoint, under "state_dict"
    ckpt = str(tmp_path / "base.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    assert_same_tree(tconv.load_sdxl_checkpoint(ckpt, *cfgs_t), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(7, 5, generator=g).to(dtype),
               "b": torch.randn(3, generator=g).to(dtype),
               "scalar": torch.tensor(2.5).to(dtype), "empty": torch.zeros(0, 4).to(dtype),
               "ids": torch.arange(77, dtype=torch.int64)[None]}
    path = str(tmp_path / "x.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    want, got = st.load_file(path), load_safetensors(path)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(got[k], want[k])


# ---------------------------------------------------------------------------
# delta checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def delta_setup():
    jcfg = JUNetCfg(**TINY_UNET)
    init = lambda k: {  # noqa: E731
        "unet": init_unet_params(k, jcfg),
        "conditioner": {"clip_l": init_clip_text_params(k, JClipCfg(**CLIP_KW)),
                        "open_clip": init_clip_text_params(k, JClipCfg(**OPEN_KW))},
    }
    source = random_params(init, seed=7)
    refs = {}
    for _, _, attn_id, d in jdelta.iter_pose_blocks(jcfg):
        refs.setdefault(attn_id, {})[d] = np.full((3, 16, 8), attn_id + 0.5 * d, np.float32)
    delta = jdelta.extract_delta(jax.tree.map(jnp.asarray, source), refs, jcfg)
    return random_params(init, seed=8), delta


def test_apply_delta_matches_jax(delta_setup):
    target, delta = delta_setup
    jp, jrefs = jdelta.apply_delta_state_dict(jax.tree.map(jnp.asarray, target), delta,
                                              JUNetCfg(**TINY_UNET))
    tp, trefs = tdelta.apply_delta_state_dict(to_torch(target), delta, UNetConfig(**TINY_UNET))
    assert_same_tree(tp, to_torch(_jax_np(jp)))
    assert_same_tree(trefs, to_torch(_jax_np(jrefs)))


def test_delta_npz_roundtrip_matches_jax(delta_setup, tmp_path):
    _, delta = delta_setup
    tdelta.save_delta_npz(str(tmp_path / "t.npz"), delta)
    jdelta.save_delta_npz(str(tmp_path / "j.npz"), delta)
    for path in ("t.npz", "j.npz"):
        got = tdelta.load_delta_npz(str(tmp_path / path))
        want = jdelta.load_delta_npz(str(tmp_path / path))
        assert got.keys() == want.keys() == delta.keys()
        for k in delta:
            pairs = zip(got[k], want[k]) if k == "embed" else [(got[k], want[k])]
            for a, b in pairs:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("extra", [False, True], ids=["weights_only", "pickled_extras"])
def test_load_delta_torch(delta_setup, tmp_path, extra):
    """A reference .ckpt: {"delta_state_dict": {...}} (bf16 rows included),
    with or without objects that weights_only=True refuses."""
    _, delta = delta_setup
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in delta.items() if k != "embed"}
    sd["embed"] = [torch.from_numpy(np.asarray(r)).to(torch.bfloat16) for r in delta["embed"]]
    obj = {"delta_state_dict": sd}
    if extra:
        obj["hyper_parameters"] = argparse.Namespace(lr=1e-5)
    path = str(tmp_path / "delta.ckpt")
    torch.save(obj, path)
    got = tdelta.load_delta_torch(path)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        for a, b in (zip(got[k], v) if k == "embed" else [(got[k], v)]):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # it applies as the npz form does
    tp, _ = tdelta.apply_delta_state_dict(to_torch(delta_setup[0]), got, UNetConfig(**TINY_UNET))
    assert tp["conditioner"]["clip_l"]["modifier_rows"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def test_cameras_npz_roundtrip_matches_jax(tmp_path):
    train, val = random_cameras(5, seed=1), random_cameras(3, seed=2)
    jcio.save_cameras_npz(str(tmp_path / "j.npz"), train=train, val=val)
    got = tcio.load_cameras_npz(str(tmp_path / "j.npz"))
    want = jcio.load_cameras_npz(str(tmp_path / "j.npz"))
    assert got.keys() == want.keys() == {"train", "val"}
    for split in got:
        for a, b in zip(got[split], want[split]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's writer reads back in the JAX package
    tcio.save_cameras_npz(str(tmp_path / "t.npz"), **got)
    back = jcio.load_cameras_npz(str(tmp_path / "t.npz"))
    for split in got:
        for a, b in zip(back[split], want[split]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert isinstance(back["val"], JCams)

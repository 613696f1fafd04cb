"""Fixtures shared by the port's model-family tests
(tests/test_torch_families*.py): every family's smoke config with f32
weights and adapters drawn with numpy, inputs with the vlm patches and
audio frames, and JAX's compile at a low optimization level."""
import dataclasses as dc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import lora as jlora
from repro.models import transformer as jtf
from repro_torch import configs as tcfg
from repro_torch.models.lora import LoRAContext as TCtx

ARCHS = ["deepseek-moe-16b", "granite-moe-3b-a800m", "mamba2-2.7b",
         "zamba2-2.7b", "whisper-small", "pixtral-12b"]
B, S, S_MAX, N_PATCHES, N_FRAMES = 2, 12, 32, 4, 10
JCTX = jlora.LoRAContext(mode="single", params=None, scaling=2.0)
TCTX = TCtx(mode="single", params=None, scaling=2.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one intra-op thread keeps torch from
    competing for the cores with the suite's other workers (imported by
    each test module, which makes it apply there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def targets(cfg):
    """The config's adapter targets without ``ssm_in`` (which the JAX
    module cannot apply; tests/test_torch_ssm.py holds the port's
    refusal), and with the cross-attention targets on the audio
    family."""
    t = tuple(x for x in cfg.lora.targets if x != "ssm_in")
    if cfg.family == "audio":
        t += ("xq", "xk", "xv")
    return t


def draw(defs, seed: int):
    """A ParamDef tree of the JAX package drawn with numpy in f32 under
    its init rule (``models/param.py``: ``scale``, else 1/sqrt(shape[0])
    for a matrix, 1/sqrt(shape[-1]) for a vector; zeros and ones)."""
    rng = np.random.default_rng(seed)

    def one(d):
        if d.init in ("zeros", "ones"):
            return getattr(np, d.init)(d.shape, np.float32)
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        std = d.scale if d.scale is not None else fan_in ** -0.5
        return (std * rng.standard_normal(d.shape)).astype(np.float32)

    return jax.tree.map(one, defs, is_leaf=lambda x: hasattr(x, "shape"))


def compile_o0(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at XLA's backend optimization
    level 0: these graphs are tiny, and it compiles in ~2/3 of the time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(jax cfg, port cfg, jax params, numpy params, numpy adapters)."""
    jcfg, cfg = smoke_config(arch), tcfg.smoke_config(arch)
    jcfg = dc.replace(jcfg, lora=dc.replace(jcfg.lora,
                                            targets=targets(jcfg)))
    cfg = dc.replace(cfg, lora=dc.replace(cfg.lora, targets=targets(cfg)))
    nparams = draw(jtf.model_defs(jcfg), 0)
    rng = np.random.default_rng(1)
    lora = jax.tree.map(     # every leaf std 0.05 (b too, which inits 0)
        lambda d: (0.05 * rng.standard_normal(d.shape)).astype(np.float32),
        jtf.lora_defs_tree(jcfg), is_leaf=lambda x: hasattr(x, "shape"))
    return jcfg, cfg, jax.tree.map(jnp.asarray, nparams), nparams, lora


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, N_PATCHES, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, N_FRAMES, cfg.d_model)).astype(np.float32)
    return out


def th(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)

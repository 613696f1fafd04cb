"""mamba2-2.7b's f32 decode-vs-forward gap in the JAX package and in the
port, on the CPU, on the same weights and tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mamba2_decode_gap.py \
        --layers 8 --seed 0

The config is mamba2-2.7b at its published width with its depth cut to
``--layers`` (the whole model does not fit a shared CPU host in f32, in
two frameworks at once).  Weights are drawn with numpy at
1/sqrt(fan-in) (``launch/families.py::fan_in_defs``), as
``chip_smoke.py`` phase 9 (c) draws them; the prompt is
``families.prompt_len`` tokens (two SSD chunks + 17, so prefill runs the
inter-chunk recurrence and the padded tail), then ``families.STEPS``
decode steps of given tokens.  Prints one JSON line: each framework's
largest difference between its decode logits and its own train-mode
forward at the same positions, and the two decodes' difference.
"""
import argparse
import dataclasses as dc
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import transformer as jtf
from repro.models.layers import logits_fwd as jlogits
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.launch.families import STEPS, fan_in_defs, prompt_len
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import logits_fwd


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    L, seed = args.layers, args.seed
    cfg = dc.replace(get_config("mamba2-2.7b"), num_layers=L)
    jcfg = dc.replace(jget("mamba2-2.7b"), num_layers=L)
    rng = np.random.default_rng(seed)
    nparams = _draw(fan_in_defs(ttf.model_defs(cfg)), rng)
    P, B = prompt_len(cfg), 2
    toks = rng.integers(0, cfg.vocab_size, (B, P + STEPS)).astype(np.int32)

    tp = to_torch(nparams)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        c = ttf.init_cache(cfg, B, P + STEPS, device="cpu",
                           dtype=torch.float32)
        lg, c = ttf.prefill(tp, {"tokens": tt[:, :P]}, cfg, c)
        outs = [lg[:, -1]]
        for i in range(STEPS):
            lg, c = ttf.decode_step(tp, tt[:, P + i:P + i + 1], cfg, c)
            outs.append(lg[:, -1])
        h, _, _ = ttf.forward(tp, cfg, tokens=tt, mode="train")
        ref = logits_fwd(tp["embed"], h[:, -(STEPS + 1):], cfg)
    port = torch.stack(outs, 1).numpy()
    del tp

    jp = jax.tree.map(jnp.asarray, nparams)
    jt = jnp.asarray(toks)
    jc = jtf.init_cache(jcfg, B, P + STEPS, dtype=jnp.float32)
    lg, jc = jax.jit(lambda p, t, c: jtf.prefill(p, {"tokens": t}, jcfg, c))(
        jp, jt[:, :P], jc)
    jouts = [lg[:, -1]]
    dec = jax.jit(lambda p, t, c: jtf.decode_step(p, t, jcfg, c))
    for i in range(STEPS):
        lg, jc = dec(jp, jt[:, P + i:P + i + 1], jc)
        jouts.append(lg[:, -1])
    h, _, _ = jax.jit(lambda p, t: jtf.forward(p, jcfg, tokens=t,
                                               mode="train"))(jp, jt)
    jref = np.asarray(jlogits(jp["embed"], h[:, -(STEPS + 1):], jcfg))
    jdec = np.asarray(jnp.stack(jouts, 1))
    print(json.dumps(dict(
        arch="mamba2-2.7b", layers=L, d_model=cfg.d_model, seed=seed,
        prompt=P, steps=STEPS,
        port_decode_vs_forward=float(np.abs(port - ref.numpy()).max()),
        jax_decode_vs_forward=float(np.abs(jdec - jref).max()),
        port_vs_jax_decode=float(np.abs(port - jdec).max()),
        logit_max_abs=float(np.abs(jref).max()))))


def _draw(defs, rng):
    """A ParamDef tree drawn with numpy in f32 at each leaf's std."""
    if isinstance(defs, dict):
        return {k: _draw(v, rng) for k, v in defs.items()}
    d = defs
    if d.init in ("zeros", "ones"):
        return getattr(np, d.init)(d.shape, np.float32)
    fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    std = d.scale if d.scale is not None else fan_in ** -0.5
    if d.init == "small":
        std = (d.scale or 1.0) * 0.02
    return (std * rng.standard_normal(d.shape)).astype(np.float32)

if __name__ == "__main__":
    main()

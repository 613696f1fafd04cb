"""The moe and ssm families of tests/test_torch_spmd_dryrun.py: the dry
run's step on a mesh of more than one rank
(``launch/dryrun.py``: the sharded step on ``meta`` tensors as rank 0 of
a fake process group) against the JAX package's per-device dot flops of
the same cell, compiled with ``in_shardings`` on 4 fake devices (2, 2) in
a child process (``--xla_force_host_platform_device_count``) and read by
``repro.launch.hlo_cost.analyze_hlo``, as
``tests/test_torch_dryrun.py::_jax_dot_flops`` reads one device's.

Rank 0's matrix-product flops are within 10% of JAX's per device: the
prefill and decode steps of the smoke configs of the dense, moe and ssm
families, and the dense train step (here the dense family;
tests/test_torch_spmd_dryrun_families.py the moe and ssm).  The moe and
ssm train steps differ by what each framework writes as a matrix product
in the backward (``test_torch_dryrun.train_gap``), here at the rank's
tokens, and are held within 10% after it.  The check shows that DTensor
gathers the weights over the batch axes (FSDP) and keeps the activations
sharded, as GSPMD does: replicated work would not split the flops four
ways.
"""
import pytest

import spmd_common as sc

ARCHS = ('granite-moe-3b-a800m', 'mamba2-2.7b')


@pytest.fixture(scope="module")
def jax_flops():
    proc = sc.start_jax_flops(ARCHS)
    yield proc, {}
    if proc.poll() is None:
        proc.kill()


@pytest.mark.parametrize("kind", ("prefill", "decode", "train"))
@pytest.mark.parametrize("arch", ARCHS)
def test_rank0_matmul_flops_match_jax_per_device(jax_flops, arch, kind):
    sc.check_rank0_flops(sc.jax_flops_of(*jax_flops), arch, kind)

"""The yardstick's arithmetic against counts made by hand."""
import pytest

from portbench import flops, spec

TINY = {"layers": 1, "d": 4, "heads": 2, "kv_heads": 1, "head_dim": 2,
        "experts": 0, "top_k": 0}


def test_dense_flops_by_hand():
    sv = {"rank": 1, "targets": ["q"], "mode": "lora"}
    # weights a token meets: q 4*4, k 4*2, v 4*2, o 4*4 = 48; mlp 3*4*8 = 96;
    # the q adapter 1*(4+4) = 8  ->  152 multiply-adds a token
    # attention: 2 * heads 2 * hd 2 * S (S + 1) = 8 S (S + 1)
    # unembedding of one position: 2 * 4 * 10
    S = 3
    want = 2 * 152 * S + 8 * S * (S + 1) + 2 * 4 * 10
    assert flops.prefill_flops(TINY, 8, 10, sv, S) == want


def test_jd_adapter_adds_sigma():
    lora = {"rank": 2, "targets": ["q", "o"], "mode": "lora"}
    jd = dict(lora, mode="jd")
    # per target r*r more multiply-adds a token, two targets
    d = flops.prefill_flops(TINY, 8, 10, jd, 5) \
        - flops.prefill_flops(TINY, 8, 10, lora, 5)
    assert d == 2 * 5 * 2 * 4


def test_moe_counts_chosen_experts_and_router():
    rc = dict(TINY, experts=4, top_k=2)
    sv = {"rank": 1, "targets": [], "mode": "lora"}
    # attention 48; 2 chosen experts of 3*4*8 = 192; router 4*4 = 16
    S = 2
    want = 2 * (48 + 192 + 16) * S + 8 * S * (S + 1) + 2 * 4 * 10
    assert flops.prefill_flops(rc, 8, 10, sv, S) == want


@pytest.mark.parametrize("name,n_active", [
    # 32 layers of q, k, v, o and the MLP (the embeddings not counted)
    ("mistral-7b-jd1000", 32 * (2 * 4096 * 4096 + 2 * 4096 * 1024
                                + 3 * 4096 * 14336)),
    # 32 layers of attention, 8 of 40 experts of width 512, the router
    ("granite-moe-3b-a800m-lora1000", 32 * (2 * 1536 * 1536
                                            + 2 * 1536 * 512
                                            + 8 * 3 * 1536 * 512
                                            + 1536 * 40)),
])
def test_full_size_linear_flops(name, n_active):
    conf = spec.load_json(spec.HERE / "configs" / f"{name}.json")
    rc = spec.reference_config(conf)
    sv = dict(conf["serving"], targets=[])
    S = 1
    got = flops.prefill_flops(rc, conf["intermediate_size"],
                              conf["vocab_size"], sv, S)
    attn = 32 * 2 * rc["heads"] * rc["head_dim"] * 2
    assert got == 2 * n_active + attn + 2 * rc["d"] * conf["vocab_size"]

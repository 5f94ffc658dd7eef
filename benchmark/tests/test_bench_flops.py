"""flops.py's count of one batched-CFG UNet eval against a count by hand,
at a one-level UNet."""

import json
import os

from conftest import HERE

import flops


def tiny_one_level():
    cfg = json.load(open(os.path.join(HERE, "tiny.json")))
    cfg["unet"].update(channel_mult=[1], num_res_blocks=1,
                       attention_resolutions=[1], temporal_length=2)
    cfg["video"] = {"height": 32, "width": 32, "frames": 2}
    return cfg


def hand_count(cfg, batch=2):
    u = cfg["unet"]
    mc, hc, ctx = u["model_channels"], u["num_head_channels"], u["context_dim"]
    ted, t = 4 * mc, cfg["video"]["frames"]
    hw = (cfg["video"]["height"] // 8) * (cfg["video"]["width"] // 8)
    lt, li = u["text_context_len"], u["img_tokens_per_frame"]
    s = batch * t                   # frames
    n = s * hw                      # tokens

    def lin(rows, a, b):
        return 2 * rows * a * b

    def conv3(cin, cout):
        return 2 * n * 9 * cin * cout

    def res(cin, cout):
        f = conv3(cin, cout) + conv3(cout, cout) + lin(s, ted, cout)
        f += 12 * lin(n, cout, cout)            # four (3, 1, 1) convs
        return f + (lin(n, cin, cout) if cin != cout else 0)

    def block(d, seq, cross):
        f = 4 * lin(n, d, d) + 4 * n * seq * d  # attn1
        if cross:
            f += 2 * lin(n, d, d) + 2 * lin(s * lt, ctx, d) \
                + 2 * lin(s * li, ctx, d) + 4 * n * (lt + li) * d
        else:
            f += 4 * lin(n, d, d) + 4 * n * seq * d
        return f + lin(n, d, 8 * d) + lin(n, 4 * d, d)

    def spatial(ch):
        return 2 * lin(n, ch, ch) + block(ch, hw, True)

    def temporal(ch, inner):
        return 2 * lin(n, ch, inner) + block(inner, t, False)

    emb = 2 * (lin(batch, mc, ted) + lin(batch, ted, ted))
    total = emb + conv3(u["in_channels"], mc) + temporal(mc, 8 * hc)
    total += res(mc, mc) + spatial(mc) + temporal(mc, mc)        # level 0
    total += 2 * res(mc, mc) + spatial(mc) + temporal(mc, mc)    # middle
    total += 2 * (res(2 * mc, mc) + spatial(mc) + temporal(mc, mc))
    return total + conv3(mc, u["out_channels"])


def test_unet_eval_matches_hand_count():
    cfg = tiny_one_level()
    assert flops.i2v_parts(cfg)["cfg_eval"] == hand_count(cfg)


def test_clip_is_conditioning_steps_and_decode():
    cfg = tiny_one_level()
    p = flops.i2v_parts(cfg)
    assert flops.i2v_clip(cfg) == (p["conditioning"] + cfg["sampler"]["steps"]
                                   * p["cfg_eval"] + p["decode"])

"""How far tensor parallelism's arithmetic alone moves a bfloat16 model, in
one process on one card: no ranks, no collectives.

    python3 tools/tp_rounding.py configs/model/large.toml

Builds the config's model in bfloat16 (random weights from seed 0) and
takes one micro-batch's loss and gradients on (2, seq_len + 1) random
tokens four ways: plainly; with every column-parallel product
(``to_qkv``, ``proj_in``, the SGU's ``proj_out``, ``to_logits``) cut in
two output blocks, as two model ranks compute it, its input gradient
summed over the blocks in float32 and rounded once; with every
row-parallel product (``to_out``, the feed-forward's ``proj_out``) cut
in two input halves whose float32 partial products are summed and
rounded once; and with both. ``parallel/tensor.py`` computes these
products so on a grid. Each is held against the plain run, and the
float32 model against it too, for scale. Prints one line each: the
loss, its relative distance from the plain run's, the largest per-tensor
relative distance of the gradients and the four lowest cosines.
"""

import argparse
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

COLUMN = ("to_qkv", "proj_in", "sgu.proj_out", "to_logits")
ROW = ("to_out", "proj_out")


def _col(matmul_f32):
    class Col(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return torch.cat([F.linear(x, p) for p in w.chunk(2, 0)], -1)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
            gx = sum(matmul_f32(a, b) for a, b in zip(g2.chunk(2, -1),
                                                      w.chunk(2, 0)))
            gw = torch.cat([a.t() @ x2 for a in g2.chunk(2, -1)], 0)
            return gx.to(x.dtype).view_as(x), gw
    return Col


def _row(matmul_f32):
    class Row(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            x2 = x.reshape(-1, x.shape[-1])
            y = sum(matmul_f32(a, b.t()) for a, b in zip(x2.chunk(2, -1),
                                                         w.chunk(2, 1)))
            return y.to(x.dtype).view(*x.shape[:-1], -1)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
            gx = torch.cat([g2 @ b for b in w.chunk(2, 1)], -1)
            gw = torch.cat([g2.t() @ a for a in x2.chunk(2, -1)], 1)
            return gx.view_as(x), gw
    return Row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("config", help="a model TOML")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    from progen_tpu_torch import ProGen, ProGenConfig, load_toml_config
    from progen_tpu_torch.models import layers
    from progen_tpu_torch.parallel.tensor import matmul_f32
    from progen_tpu_torch.training.step import batch_loss

    cfg = ProGenConfig.from_dict(load_toml_config(args.config))
    model = ProGen(cfg, device=args.device, seed=0)
    rng = np.random.default_rng(14)
    data = torch.from_numpy(rng.integers(1, cfg.num_tokens,
                                         (2, cfg.seq_len + 1))).to(
        model.device)
    kind = {}
    for name, m in model.named_modules():
        if isinstance(m, layers.Dense):
            kind[id(m)] = ("column" if name.endswith(COLUMN) else
                           "row" if name.endswith(ROW) else None)
    col, row, plain = _col(matmul_f32), _row(matmul_f32), \
        layers.Dense.forward

    def forward(cut_col, cut_row):
        def fwd(self, x, dtype):
            x, w = x.to(dtype), self.weight.to(dtype)
            k = kind[id(self)]
            y = (col.apply(x, w) if k == "column" and cut_col else
                 row.apply(x, w) if k == "row" and cut_row else
                 F.linear(x, w))
            return y if self.bias is None else y + self.bias.to(dtype)
        return fwd

    def grads(net, fwd=plain):
        with mock.patch.object(layers.Dense, "forward", fwd):
            net.zero_grad(set_to_none=True)
            loss = batch_loss(net, data)
            loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in net.named_parameters()}

    def report(tag, got, want):
        rel = max(float((got[1][n] - want[1][n]).norm() / want[1][n].norm())
                  for n in want[1])
        cos = sorted((float(F.cosine_similarity(
            got[1][n].flatten().double(), want[1][n].flatten().double(),
            dim=0)), n) for n in want[1])
        print(tag, {"loss": got[0],
                    "loss_rel": abs(got[0] - want[0]) / abs(want[0]),
                    "grads_max_rel": rel, "lowest_cos": cos[:4]},
              flush=True)

    base = grads(model)
    for tag, c, r in (("column", True, False), ("row", False, True),
                      ("both", True, True), ("plain again", False, False)):
        report(tag, grads(model, forward(c, r)), base)
    m32 = ProGen(ProGenConfig(**{**cfg.to_dict(), "dtype": "float32"}),
                 device=args.device, seed=None)
    m32.load_state_dict(model.state_dict())
    report("float32", grads(m32), base)


if __name__ == "__main__":
    main()

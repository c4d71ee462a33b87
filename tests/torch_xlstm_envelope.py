"""xlstm's float32 rounding against the reference's, on the CPU.

Each of K weight sets (the tests' ``float32_params``, every element moved by
±2⁻²⁴ relative, seeded) runs through the reference and the port in float32
and through the port in float64; each float32 run's distance from the
float64 port on its own weights is measured, and the medians and ranges are
printed, the port's against the reference's:

* ``decode``: the cached prefill of 32 tokens and 4 decode steps
  (``test_torch_tensor_parallel_decode.py``'s inputs) at batch ``--b``: the
  largest step's logits and every cache leaf;
* ``grads``: ``train_loss``'s gradient at B = 4
  (``test_torch_tensor_parallel_ssm.py``'s batch): the mLSTM leaves, and
  the largest of their five farthest, a weight set.

``--revert gates`` puts back the mLSTM's gate products as one PyTorch
product, ``--revert rsqrt`` the RMS norms' ``torch.rsqrt``, so that the
repairs' effects can be read off; ``--float64-scale`` gives the norms a
correctly rounded scale instead (a float64 root, rounded once), the
alternative that the port does not take.  ``--meshes`` adds the sharded tests'
meshes on the tests' own weights: for ``decode`` each mesh's largest
distance from the float64 port against twice the reference's envelope
(the bound of ``test_sharded_prefill_and_decode_match_reference``), for
``grads`` each mesh's largest leaf distance from the reference's gradient.
Usage (from the repository root)::

    PYTHONPATH=src:tests python tests/torch_xlstm_envelope.py decode --b 1 --k 16
    PYTHONPATH=src:tests python tests/torch_xlstm_envelope.py grads --k 24 --revert rsqrt
"""
from __future__ import annotations

import argparse

import jax
import numpy as np
import torch

from repro_torch.bridge import lm_params_from_numpy
from repro_torch.models.lm import layers
from repro_torch.models.lm import ssm as ssm_lib
from repro_torch.optim.adamw import tree_map
from repro_torch.train.step import loss_and_grads
from torch_tp_probes import float64_port
from torch_train_parity import (
    batch,
    float32_params,
    grad_errors,
    models,
    ref_loss_and_grads,
    to_ref,
    walk,
)

ARCH = "xlstm-1.3b"


def revert(names) -> None:
    if "gates" in names:
        ssm_lib._gate_product = lambda x, w: x @ w
    if "rsqrt" in names:
        layers.rsqrt = ssm_lib.rsqrt = torch.rsqrt


def float64_scale() -> None:
    layers.rsqrt = ssm_lib.rsqrt = lambda v: torch.rsqrt(v.double()).to(v.dtype)


def _summary(name: str, ref: np.ndarray, port: np.ndarray) -> str:
    return (f"{name:8s} reference median {np.median(ref):.3g} [{ref.min():.3g}, {ref.max():.3g}]"
            f"  port median {np.median(port):.3g} [{port.min():.3g}, {port.max():.3g}]"
            f"  ratio {np.median(port) / np.median(ref):.2f}")


def decode(k: int, b: int, meshes: bool) -> None:
    import test_torch_tensor_parallel_decode as dec

    dec.N_NUDGED = k
    ref_rows, port_rows = dec._envelope(ARCH, b)
    names = ["logits", *ref_rows[0][1]]

    def column(rows, n):
        return np.array([max(r[0]) if n == "logits" else r[1][n] for r in rows])

    print(f"decode B={b}, {k} weight sets: distance from the float64 port")
    for n in names:
        print(_summary(n, column(ref_rows, n), column(port_rows, n)))
    if not meshes:
        return
    for name, (dims, mb) in dec.MESHES.items():
        rows = dec._envelope(ARCH, mb)[0]
        steps, leaves = dec._errors(*dec._sharded(ARCH, dims, mb)[2:], dec._yardstick(ARCH, mb))
        bounds = [2 * max(r[0][i] for r in rows) for i in range(len(steps))]
        ratios = [e / r for e, r in zip(steps, bounds)]
        ratios += [leaves[n] / (2 * max(r[1][n] for r in rows)) for n in leaves]
        dists = steps + list(leaves.values())
        print(f"mesh {name}: distances {min(dists):.3g}-{max(dists):.3g} from the float64 port, "
              f"at most {max(ratios):.3f} of twice the reference's envelope")


def grads(k: int, meshes: bool) -> None:
    import test_torch_tensor_parallel_ssm as tp

    ref_lm, _, lm, _ = models(ARCH)
    shapes = jax.eval_shape(ref_lm.init, jax.random.PRNGKey(0))
    bt = batch(lm, seed=7, step=1, b=tp.B)
    tb = tp._torch_batch(bt)
    rows = {"reference": [], "port": []}
    from test_torch_tensor_parallel_decode import _nudged

    for i in range(k):
        tree = _nudged(float32_params(ARCH), i)
        params = lm_params_from_numpy(tree, lm.dtype)
        with float64_port(lm):
            _, _, g64 = loss_and_grads(lm, tree_map(lambda t: t.double(), params), tb)
        want = {p: v.detach().numpy() for p, v in walk(g64) if p[0] == "mlstm"}
        _, _, g_ref = ref_loss_and_grads(ref_lm, to_ref(tree, shapes), bt)
        _, _, g = loss_and_grads(lm, params, tb)
        g = {p: v.detach().numpy() for p, v in walk(g)}
        rows["reference"].append(grad_errors({p: g_ref[p] for p in want}, want))
        rows["port"].append(grad_errors({p: g[p] for p in want}, want))
    leaves = sorted(rows["reference"][0],
                    key=lambda p: -max(r[p] for r in rows["reference"]))[:5]
    print(f"train_loss gradient, B={tp.B}, {k} weight sets: distance from the float64 port")
    for p in leaves:
        print(_summary(p[-1], *(np.array([r[p] for r in rows[w]]) for w in rows)))
    print(_summary("largest", *(np.array([max(r[p] for p in leaves) for r in rows[w]])
                                for w in rows)))
    if meshes:
        for mesh in tp.MESHES:
            ref, _, _, got = tp._sharded_loss_and_grads(ARCH, mesh)
            errs = grad_errors(got, ref["grads"])
            top = max(errs, key=errs.get)
            print(f"mesh {mesh}: largest leaf {'/'.join(map(str, top))} {errs[top]:.3g} "
                  f"from the reference (GRAD_TOL {tp.GRAD_TOL})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["decode", "grads"])
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--revert", default="", help="comma-separated: gates, rsqrt")
    ap.add_argument("--float64-scale", action="store_true")
    ap.add_argument("--meshes", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    revert(args.revert.split(","))
    if args.float64_scale:
        float64_scale()
    print(f"reverted: {args.revert or 'nothing'}; float64 scale: {args.float64_scale}")
    if args.what == "decode":
        decode(args.k, args.b, args.meshes)
    else:
        grads(args.k, args.meshes)


if __name__ == "__main__":
    main()

"""Statements a state of the model-specialised kernels (K0), on the CPU.

    PYTHONPATH=. python tools/k0_statements.py [--humanoid]

For arm7 and both quadruped roots (with ``--humanoid`` the rpy humanoid
too, without the knot design): the operations each generated body
emits (``codegen.generate(...).ops``, and the effector library's at the
single leaf or FL_knee), and for K3 the two designs: one thread a
derivative column (``linearize``, the statements of one column's thread;
nv threads a knot run it) against one thread a knot holding every column,
whose column sweeps unroll with a static one-hot per column (the
statements of that one thread, the column-free part counted once).
"""
import sys

import torch

from rbdtpu_torch.kernels import codegen, colvec, fk_lane, fused
from rbdtpu_torch.model import load_asset

MODELS = (("arm7", "arm7", {}, None),
          ("rpy quadruped", "quadruped12", {"floating_base": True},
           ("FL_knee",)),
          ("quaternion quadruped", "quadruped12",
           {"floating_base": True, "root_quat": True}, ("FL_knee",)))
GRAVITY = -9.81


def knot_design(ms) -> tuple:
    """(statements of one thread a knot, of its column-free part)."""
    em = codegen.Emitter("double")
    q, qd, u = (em.inputs(n, k) for n, k in (("q", ms.nq), ("qd", ms.nv),
                                              ("u", ms.nv)))
    start = em.count
    X = [fused._body_xc(ms, i, q) for i in range(ms.nb)]
    qdd = fused.aba_lane(ms, q, qd, u, GRAVITY, X=X)
    v, a, f, _ = fused._rnea_sweeps_lane(ms, X, qd, qdd, GRAVITY)
    base = em.count - start
    for c in range(ms.nv):
        oh = lambda i, c=c: 1.0 if i == c else 0.0
        colvec.minv_colvec(ms, X, oh)
        for wrt in ("q", "qd"):
            colvec.grad_pass_colvec(ms, X, q, qd, v, a, f, oh, wrt, GRAVITY)
    return em.count - start, base


def main():
    models = MODELS
    if "--humanoid" in sys.argv[1:]:
        models += (("rpy humanoid", "humanoid30", {"floating_base": True},
                    ("left_arm_wrist_roll",)),)
    for tag, asset, kw, ee in models:
        m = load_asset(asset, device="cpu", dtype=torch.float64, **kw)
        ops = dict(codegen.generate(m, torch.float64, GRAVITY).ops)
        ops.update(codegen.generate_ee(m, torch.float64,
                                       *fk_lane._single_ee(m, ee)).ops)
        print(f"{tag}: " + ", ".join(f"{k} {v}" for k, v in ops.items()))
        if asset == "humanoid30":
            continue
        knot, base = knot_design(fused.get_static(m))
        print(f"{tag}: K3 one thread a column {ops['linearize']} "
              f"statements (x nv = {m.nv} threads a knot: "
              f"{ops['linearize'] * m.nv} executed); one thread a knot "
              f"{knot} statements ({base} of them column-free)")


if __name__ == "__main__":
    main()

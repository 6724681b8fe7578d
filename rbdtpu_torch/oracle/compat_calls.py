"""The compat mirror's calls: every method of the reference-compatible
per-pass API (``rbdtpu_torch.compat.RBDReferenceTorch``, or any mirror
with its names and keywords), with the models and the one numpy state a
model they run on.  tests/make_compat_fixture.py records rbdtpu's mirror
on them, tests/test_torch_compat.py holds the port's against that record,
and tests/test_torch_cuda.py and chip_smoke.py hold the port's mirror on
the card against the CPU.  Numpy and the standard library only."""
import numpy as np

SEED = 20261101
# model tag -> (asset, load_asset keywords)
MODELS = {"arm7": ("arm7", {}),
          "quad": ("quadruped12", {"floating_base": True}),
          "hum_q": ("humanoid30", {"floating_base": True, "root_quat": True})}
# end effectors and homogeneous offsets of the named-EE calls
EE = {"arm7": ("joint6",), "quad": ("FL_knee", "RR_knee"),
      "hum_q": ("left_arm_wrist_roll",)}
OFFSET = (0.01, -0.02, 0.05, 1.0)
DAMPING = 0.05
STATE_KEYS = ("q", "qd", "qdd", "u", "f_ext", "f_in")


def state(model_tag: str, nq: int, nv: int, nb: int):
    """One state: q (a standing root pose plus 0.3 N(0,1) on the joints;
    on the quaternion root a normalised quaternion near the identity), qd,
    qdd, u, a world wrench a body (NB, 6) and per-body forces (6, NB)."""
    rng = np.random.default_rng(SEED + sum(map(ord, model_tag)))
    q = 0.3 * rng.standard_normal(nq)
    if model_tag != "arm7":
        q[2] = 0.9
        if model_tag == "hum_q":
            quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.standard_normal(4)
            q[3:7] = quat / np.linalg.norm(quat)
    return dict(q=q, qd=rng.standard_normal(nv), qdd=rng.standard_normal(nv),
                u=5.0 * rng.standard_normal(nv),
                f_ext=rng.standard_normal((nb, 6)),
                f_in=rng.standard_normal((6, nb)))


def calls(c, tag: str, s: dict):
    """(name, thunk) of every mirrored call on ``c`` (rbdtpu's or the
    port's mirror) at the state ``s``; each thunk returns a tuple of
    arrays."""
    q, qd, qdd, u = s["q"], s["qd"], s["qdd"], s["u"]

    def rnea_va():
        _, v, a, f = c.rnea(q, qd, qdd)
        return v, a, f

    def fpass_dq():
        v, a, _ = rnea_va()
        return c.rnea_grad_fpass_dq(q, qd, v, a)

    def fpass_dqd():
        v, _, _ = rnea_va()
        return c.rnea_grad_fpass_dqd(q, qd, v)

    yield "rnea", lambda: c.rnea(q, qd, qdd)
    yield "rnea_bias", lambda: c.rnea(q, qd)
    yield "rnea_f_ext", lambda: c.rnea(q, qd, qdd, f_ext=s["f_ext"])
    yield "rnea_fpass", lambda: c.rnea_fpass(q, qd, qdd)
    yield "rnea_bpass", lambda: c.rnea_bpass(q, c.rnea_fpass(q, qd, qdd)[2])
    yield "apply_external_forces", lambda: (c.apply_external_forces(
        q, s["f_in"], s["f_ext"].T),)
    yield "minv", lambda: (c.minv(q),)
    yield "minv_upper", lambda: (c.minv(q, output_dense=False),)
    yield "crba", lambda: (c.crba(q),)
    yield "aba", lambda: (c.aba(q, qd, u),)
    yield "aba_f_ext", lambda: (c.aba(q, qd, u, f_ext=s["f_ext"],
                                      GRAVITY=-9.0),)
    yield "forward_dynamics", lambda: (c.forward_dynamics(q, qd, u),)
    yield "forward_dynamics_grad", lambda: c.forward_dynamics_grad(q, qd, u)
    yield "minv_bpass", lambda: c.minv_bpass(q)
    yield "minv_fpass", lambda: (c.minv_fpass(q, *c.minv_bpass(q)),)
    yield "rnea_grad_fpass_dq", fpass_dq
    yield "rnea_grad_fpass_dqd", fpass_dqd
    yield "rnea_grad_bpass_dq", lambda: (c.rnea_grad_bpass_dq(
        q, rnea_va()[2], fpass_dq()[2]),)
    yield "rnea_grad_bpass_dqd", lambda: (c.rnea_grad_bpass_dqd(
        q, fpass_dqd()[2], USE_VELOCITY_DAMPING=True),)
    yield "rnea_grad", lambda: (c.rnea_grad(q, qd, qdd),)
    yield "rnea_grad_damped", lambda: (c.rnea_grad(
        q, qd, qdd, GRAVITY=-9.0, USE_VELOCITY_DAMPING=True),)
    yield "second_order_idsva_parallel", lambda: (
        c.second_order_idsva_parallel(q, qd, qdd))
    yield "fdsva_so", lambda: c.fdsva_so(q, qd, u)
    yield "end_effector_pose", lambda: (c.end_effector_pose(q),)
    yield "end_effector_pose_named", lambda: (c.end_effector_pose(
        q, ee_joint_names=EE[tag], ee_offsets=OFFSET),)
    yield "end_effector_pose_gradient", lambda: (
        c.end_effector_pose_gradient(q, ee_joint_names=EE[tag]),)
    yield "end_effector_pose_hessian", lambda: (
        c.end_effector_pose_hessian(q, ee_joint_names=EE[tag],
                                    ee_offsets=OFFSET),)


# the calls, in order
NAMES = tuple(name for name, _ in calls(None, "arm7",
                                        dict.fromkeys(STATE_KEYS)))

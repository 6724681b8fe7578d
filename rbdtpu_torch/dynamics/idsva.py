"""Second-order inverse and forward dynamics derivatives (IDSVA-SO and
FDSVA-SO, ``rbdtpu.dynamics.idsva``), two ways:

``idsva_so_native``: one forward pass builds per-body world-frame
kinematic vectors (S, Sd, psid, psidd) and composite inertia factors (IC,
BC, f, summed over each subtree with the dense subtree mask), then every
(i, j, k) entry of the four tensors comes at once from masked dense
``torch.einsum`` bilinear forms x^T D y over per-body 6x6 factors, gated by
the ancestor masks (``_so_assemble``).  Fixed base, and both floating
roots through ``_idsva_so_native_fb``.

``idsva_so_ad``: forward-mode differentiation (``torch.func.jacfwd``,
batched with ``torch.func.vmap``) of the analytical first-order
``rnea_grad`` and of ``crba``; on the quaternion root, of RNEA twice
through the solver's retraction.  The reference the native sweep is held
against.

``idsva_so`` is the native sweep on every root.

Tensor layout:
  d2tau_dq[i, j, k]   = d2 tau_i / dq_j dq_k       (symmetric in j, k)
  d2tau_dqd[i, j, k]  = d2 tau_i / dqd_j dqd_k     (symmetric in j, k)
  d2tau_dvdq[i, j, k] = d2 tau_i / dqd_j dq_k
  dM_dq[i, j, k]      = dM_ij / dq_k               (symmetric in i, j)
On the quaternion root every q derivative is one of the tangent chart
centred at q (``solver.integrate.config_retract``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..model.robot import RobotModel
from ..spatial.ops import (
    cross_force, cross_motion, dot_inertia, factor_inertia, icrf, mv,
)
from .crba import crba
from .fd import forward_dynamics_full
from .rnea import gravity_accel, rnea
from .rnea_grad import gravity_seed_derivs, rnea_grad
from .xforms import joint_transforms_list


def _x_inv(X):
    """Inverse of a spatial motion transform [[E, 0], [B, E]] without a
    general 6x6 solve: [[E^T, 0], [-E^T B E^T, E^T]]."""
    Et = X[..., :3, :3].transpose(-1, -2)
    Bi = -Et @ X[..., 3:, :3] @ Et
    top = torch.cat([Et, torch.zeros_like(Et)], dim=-1)
    return torch.cat([top, torch.cat([Bi, Et], dim=-1)], dim=-2)


def _mask(m, like):
    return torch.as_tensor(np.asarray(m, np.float64), dtype=like.dtype,
                           device=like.device)


def _body_pass(model: RobotModel, Xs, qd, qdd, v0, a0, first: int):
    """The world-frame (fixed base) or root-frame (floating root, Xup[0] =
    identity) forward pass over bodies ``first``..NB-1, stacked over them:
    S, Sd, psid, psidd (..., m, 6) and IC, BC, f (..., m, 6[, 6]) before
    the subtree sums.  ``v0``/``a0`` are the velocity and acceleration the
    top bodies' parent carries (the root's, or zero and the gravity seed).
    Only the transforms' chain and the v/a recursion loop over bodies; the
    rest is batched over them."""
    nb = model.nb
    bodies = range(first, nb)
    top = lambda i: model.parent[i] in (-1, first - 1)
    Xup = [None] * nb
    for i in bodies:
        Xup[i] = Xs[i] if top(i) else Xs[i] @ Xup[model.parent[i]]
    X = torch.stack(Xup[first:], dim=-3)
    S = mv(_x_inv(X), model.S[first:])
    cols = [model.v_index(i) for i in bodies]
    vJ = S * qd[..., cols, None]
    aJ = S * qdd[..., cols, None]
    v, a, vp, ap = ([None] * nb for _ in range(4))
    for k, i in enumerate(bodies):
        p = model.parent[i]
        vp[i], ap[i] = (v0, a0) if top(i) else (v[p], a[p])
        v[i] = vp[i] + vJ[..., k, :]
        a[i] = ap[i] + cross_motion(vp[i], vJ[..., k, :]) + aJ[..., k, :]
    V, A, VP, AP = (torch.stack(x[first:], dim=-2) for x in (v, a, vp, ap))
    psid = cross_motion(VP, S)
    psidd = cross_motion(AP, S) + cross_motion(VP, psid)
    Sd = cross_motion(V, S)
    IC = X.transpose(-1, -2) @ (model.I[first:] @ X)
    # BC = crf(v) I + icrf(I v) - I crm(v) = 2 factor_inertia(I, v)
    BC = 2.0 * factor_inertia(IC, V)
    f = mv(IC, A) + cross_force(V, mv(IC, V))
    return S, Sd, psid, psidd, IC, BC, f


def _world_pass(model: RobotModel, Xs, q, qd, qdd, gravity: float):
    """World-frame forward pass with the composite f/IC/BC summed over each
    subtree by the dense subtree mask.  Returns stacked (..., n, 6[, 6])
    tensors: S, Sd, psid, psidd and the composite IC, BC, f."""
    g = gravity_accel(gravity, Xs[0].dtype, Xs[0].device).expand(
        q.shape[:-1] + (6,))
    S, Sd, psid, psidd, IC, BC, f = _body_pass(
        model, Xs, qd, qdd, torch.zeros_like(g), g, 0)
    st = _mask(model.subtree_mask(), g)
    ICc = torch.einsum("ij,...jab->...iab", st, IC)
    BCc = torch.einsum("ij,...jab->...iab", st, BC)
    fc = torch.einsum("ij,...ja->...ia", st, f)
    return S, Sd, psid, psidd, ICc, BCc, fc


def idsva_so_native(model: RobotModel, q, qd, qdd, gravity: float = -9.81,
                    *, Xs=None):
    """The direct second-order sweep on every root (the floating ones
    through ``_idsva_so_native_fb``): (..., nq), (..., nv), (..., nv) ->
    four (..., n, n, n) tensors.  ``Xs``: q's joint transforms, when the
    caller has them."""
    if Xs is None:
        Xs = joint_transforms_list(model, q)
    if model.floating_base:
        return _idsva_so_native_fb(model, Xs, q, qd, qdd, gravity)
    S, Sd, psid, psidd, IC, BC, f = _world_pass(model, Xs, q, qd, qdd,
                                                gravity)
    Astr = _mask(model.ancestor_mask(), S)
    Anc = Astr + torch.eye(model.nv, dtype=S.dtype, device=S.device)
    return _so_assemble(S, Sd, psid, psidd, IC, BC, f, Anc, Astr)


def _so_assemble(S, Sd, psid, psidd, IC, BC, f, Anc, Astr):
    """Masked dense einsum assembly of the four second-order tensors from
    per-COORDINATE world-frame quantities.

    S/Sd/psid/psidd (..., n, 6); IC/BC (..., n, 6, 6) composite (of each
    coordinate's body); f (..., n, 6); Anc/Astr (n, n) coordinate-level
    precedence (Anc[x, y]: y's body is x's body or an ancestor of it;
    Astr strict).  Holds for 1-DoF-per-body trees (fixed base, a coordinate
    a body) and for coordinate-expanded floating roots (six root
    coordinates sharing body 0): the d2qd same-body pairs are handled by
    the 3-term form below, exact for multi-DoF roots."""
    es = torch.einsum
    # per-coordinate 6x6 factors
    T1 = es("...iab,...ib->...ia", IC, S)
    T2 = -es("...iba,...ib->...ia", BC, S)  # -BC^T S
    T3 = (es("...iab,...ib->...ia", BC, psid)
          + es("...iab,...ib->...ia", IC, psidd)
          + es("...iab,...ib->...ia", icrf(f), S))
    T4 = es("...iab,...ib->...ia", BC, S) + es(
        "...iab,...ib->...ia", IC, psid + Sd)
    D1 = dot_inertia(IC, S)
    D2 = 2.0 * factor_inertia(IC, psid) + dot_inertia(BC, S)
    D3 = 2.0 * factor_inertia(IC, S)
    D4 = icrf(es("...iba,...ib->...ia", IC, S))  # icrf(IC^T S)

    # bil(D, x, y)[..., r, a, b] = x_a^T D_r y_b
    bil = lambda D, x, y: es("...red,...ae,...bd->...rab", D, x, y)
    # pairwise motion cross table: _cm(X, Y)[..., a, b, :] = X_a x Y_b
    _cm = lambda X, Y: cross_motion(X[..., :, None, :], Y[..., None, :, :])
    swap_ab = lambda t: t.transpose(-1, -2)
    # 3-D masks (r, a, b) from the 2-D precedence; "xy" reads mask[x, y]
    m3 = lambda spec, M1, M2: es(spec + "->rab", M1, M2)

    cmSS = _cm(S, S)  # [a, b] = S_a x S_b

    # ---- d2tau_dq ----
    # V1[r,a,b] = -psid_a^T D3_r psid_b - T2_r.(psid_b x S_a)
    #             + T1_r.(psidd_b x S_a)        [rows in subtree: r >= a >= b]
    V1 = (-bil(D3, psid, psid)
          - es("...re,...bae->...rab", T2, _cm(psid, S))
          + es("...re,...bae->...rab", T1, _cm(psidd, S)))
    # V2[r,a,b] = S_r^T D2_a psid_b + S_r^T D1_a psidd_b - T3_a.(S_b x S_r)
    #             [row a strict ancestor: a >= b > r]
    V2 = (es("...aed,...re,...bd->...rab", D2, S, psid)
          + es("...aed,...re,...bd->...rab", D1, S, psidd)
          - es("...ae,...bre->...rab", T3, cmSS))
    # V3[r,a,b] = S_r^T D2_b psid_a + S_r^T D1_b psidd_a   [a <= r < b]
    V3 = (es("...bed,...re,...ad->...rab", D2, S, psid)
          + es("...bed,...re,...ad->...rab", D1, S, psidd))
    d2q = (m3("ra,ab", Anc, Anc) * V1              # r >= a >= b
           + m3("rb,ba", Anc, Astr) * swap_ab(V1)  # r >= b > a
           + m3("ab,br", Anc, Astr) * V2           # a >= b > r
           + m3("ar,ba", Astr, Astr) * swap_ab(V2)  # b > a > r
           + m3("ra,br", Anc, Astr) * V3           # a <= r < b
           + m3("rb,ar", Anc, Astr) * swap_ab(V3))  # b <= r < a

    # ---- d2tau_dqd: the 3-term masked form of the bias force's velocity
    # quadratic, exact for multi-DoF roots and same-body pairs:
    #   d2tau_r/dqd_a dqd_b =
    #     [b strict-anc a] S_r^T IC_max(r,a) (S_b x S_a)      (+ a<->b swap)
    #   + [pairwise comparable] S_r^T (crf(S_a) IC_deep S_b
    #                                  + crf(S_b) IC_deep S_a)
    # with IC_deep the composite inertia of the deepest of {r, a, b} and
    # x^T crf(y) z = -(y x x).z folding the crf contractions onto cmSS.
    ICS = es("...xde,...ye->...xyd", IC, S)  # ICS[x, y] = IC_x S_y
    t1_r = m3("ra,ab", Anc, Astr) * es("...re,...bae->...rab", T1, cmSS)
    t1_a = m3("ar,ab", Astr, Astr) * es(
        "...rd,...ade,...bae->...rab", S, IC, cmSS)
    term1 = t1_r + t1_a
    M_r = m3("ra,rb", Anc, Anc)    # r at least as deep as both
    M_a = m3("ar,ab", Astr, Anc)   # a strictly deeper than r, >= b
    M_b = m3("br,ba", Astr, Astr)  # b strictly deeper than both
    t3_r = -(es("...are,...rbe->...rab", cmSS, ICS)
             + es("...bre,...rae->...rab", cmSS, ICS))
    t3_a = -(es("...are,...abe->...rab", cmSS, ICS)
             + es("...bre,...ae->...rab", cmSS, T1))
    t3_b = -(es("...are,...be->...rab", cmSS, T1)
             + es("...bre,...bae->...rab", cmSS, ICS))
    d2qd = term1 + swap_ab(term1) + M_r * t3_r + M_a * t3_a + M_b * t3_b

    # ---- d2tau_dvdq, [i, j, k] = d2tau_i / dqd_j dq_k ----
    H1 = -bil(D3, S, psid)  # -S_a^T D3_r psid_b      [r >= a >= b]
    # H2[r,a,b] = -S_a^T D3_r psid_b - T2_r.(S_a x S_b)
    #             + T1_r.((Sd_a+psid_a) x S_b - 2 psid_b x S_a)  [r >= b > a]
    H2 = (H1
          - es("...re,...abe->...rab", T2, cmSS)
          + es("...re,...abe->...rab", T1, _cm(Sd + psid, S))
          - 2.0 * es("...re,...bae->...rab", T1, _cm(psid, S)))
    # H3[r,a,b] = S_r^T D3_a psid_b - T4_a.(S_b x S_r)   [a >= b > r]
    H3 = (es("...aed,...re,...bd->...rab", D3, S, psid)
          - es("...ae,...bre->...rab", T4, cmSS))
    # H46[r,a,b] = S_r^T D2_b S_a + S_r^T D1_b (Sd_a + psid_a)  [a,r < b]
    H46 = (es("...bed,...re,...ad->...rab", D2, S, S)
           + es("...bed,...re,...ad->...rab", D1, S, Sd + psid))
    H5 = es("...aed,...re,...bd->...rab", D3, S, psid)  # [b <= r < a]
    dvdq = (m3("ra,ab", Anc, Anc) * H1
            + m3("rb,ba", Anc, Astr) * H2
            + m3("ab,br", Anc, Astr) * H3
            + m3("ba,br", Astr, Astr) * H46  # a < b, r < b
            + m3("ar,rb", Astr, Anc) * H5)

    # ---- dM_dq ----
    K1 = es("...aed,...re,...bd->...rab", D4, S, S)   # S_r^T D4_a S_b
    K1b = es("...red,...ae,...bd->...rab", D4, S, S)  # S_a^T D4_r S_b
    K2 = es("...bed,...re,...ad->...rab", D1, S, S)   # S_r^T D1_b S_a
    K2b = es("...bed,...ae,...rd->...rab", D1, S, S)  # S_a^T D1_b S_r
    dM = (m3("br,ab", Astr, Anc) * K1     # r < b <= a
          + m3("ba,rb", Astr, Anc) * K1b  # a < b <= r
          + m3("ar,ba", Anc, Astr) * K2   # r <= a < b
          + m3("ra,br", Astr, Astr) * K2b)  # a < r < b
    return d2q, d2qd, dvdq, dM


def _idsva_so_native_fb(model: RobotModel, Xs, q, qd, qdd, gravity: float):
    """The native sweep on a floating root, rpy or quaternion.

    1. The sweep runs in the ROOT frame, where the root's motion subspace
       is the identity and the root pose enters tau only through the
       gravity seed u6 = X0(q_root) a_grav, in which tau is affine.
    2. Velocity coordinates and joint-q derivatives come from the
       coordinate-expanded root-frame pass: six root coordinates sharing
       body 0 with S = e_c, psid = 0, psidd = u6 x e_c, Sd = v0 x e_c,
       assembled by ``_so_assemble`` on body precedence expanded to
       coordinates.
    3. Root-pose q columns: the translation columns vanish (gravity is
       translation-invariant); the rotation columns are
         d2tau/dth_a dth_b = T1_r . d2u6/dth^2        (T1_r = IC_r S_r)
         d2tau/dq_j dth_m = -[j anc-or-self r] T1_r . (S_j x du_m)
                            + [j in strict subtree r] S_r^T D1_j du_m
       and d2tau/dqd dth = dM/dth = 0.
    On the quaternion root only du6/dth and d2u6/dth2 depend on the chart
    (``rnea_grad.gravity_seed_derivs``); its rotation columns are the tangent's
    first three (the twist's order), the rpy root's q[3:6]."""
    nb, nv = model.nb, model.nv
    batch = q.shape[:-1]
    kw = dict(dtype=Xs[0].dtype, device=Xs[0].device)
    u6 = mv(Xs[0], gravity_accel(gravity, **kw))  # gravity seed, root frame

    v0 = qd[..., 0:6]
    a0 = u6 + qdd[..., 0:6]
    S, Sd, psid, psidd, IC, BC, f = _body_pass(model, Xs, qd, qdd, v0, a0,
                                               1)
    I0 = model.I[0].expand(batch + (6, 6))
    st = _mask(model.subtree_mask(), u6)
    ICb = torch.einsum("ij,...jab->...iab", st, torch.cat(
        [I0[..., None, :, :], IC], dim=-3))
    BCb = torch.einsum("ij,...jab->...iab", st, torch.cat(
        [2.0 * factor_inertia(I0, v0)[..., None, :, :], BC], dim=-3))
    f0 = mv(I0, a0) + cross_force(v0, mv(I0, v0))
    fb_ = torch.einsum("ij,...ja->...ia", st, torch.cat(
        [f0[..., None, :], f], dim=-2))

    # ---- coordinate expansion: 6 root coordinates (body 0) + joints ----
    bmap = np.array([0] * 6 + list(range(1, nb)))
    eye6 = torch.eye(6, **kw).expand(batch + (6, 6))
    Sc = torch.cat([eye6, S], dim=-2)
    psid_c = torch.cat([torch.zeros_like(eye6), psid], dim=-2)
    # the root's parent is the inertial frame with the gravity seed
    psidd_c = torch.cat([cross_motion(u6[..., None, :], eye6), psidd],
                        dim=-2)
    Sd_c = torch.cat([cross_motion(v0[..., None, :], eye6), Sd], dim=-2)
    idx = torch.as_tensor(bmap, device=u6.device)
    ICc = ICb.index_select(-3, idx)
    BCc = BCb.index_select(-3, idx)
    fc = fb_.index_select(-2, idx)

    Ab = np.asarray(model.ancestor_mask(), np.float64)  # strict, bodies
    Astr_c = _mask(Ab[np.ix_(bmap, bmap)], u6)
    Anc_c = Astr_c + _mask(bmap[:, None] == bmap[None, :], u6)
    d2q, d2qd, dvdq, dM = _so_assemble(Sc, Sd_c, psid_c, psidd_c, ICc, BCc,
                                       fc, Anc_c, Astr_c)

    # ---- root-pose q columns (gravity blocks) ----
    # the rotation tangent's slots among the root's six coordinates: rpy
    # q-layout [xyz, rpy] -> 3:6; the quaternion tangent follows the twist
    # [omega, v] -> 0:3
    rot = slice(0, 3) if model.root_quat else slice(3, 6)
    du, d2u = gravity_seed_derivs(model, q, gravity, second=True)
    du, d2u = du[..., rot], d2u[..., rot, rot]
    T1c = torch.einsum("...iab,...ib->...ia", ICc, Sc)
    D1c = dot_inertia(ICc, Sc)
    # zero what the sweep produced in the root's q columns
    colmask = torch.cat([torch.zeros(6, **kw), torch.ones(nv - 6, **kw)])
    d2q = d2q * colmask[:, None] * colmask[None, :]
    dvdq = dvdq * colmask
    dM = dM * colmask
    d2q[..., rot, rot] = torch.einsum("...re,...emn->...rmn", T1c, d2u)
    duT = du.transpose(-1, -2)  # (..., 3, 6)
    cmSdu = cross_motion(Sc[..., :, None, :], duT[..., None, :, :])
    cross = (-Anc_c[..., :, :, None]
             * torch.einsum("...re,...jme->...rjm", T1c, cmSdu)
             + Astr_c.transpose(-1, -2)[..., :, :, None]
             * torch.einsum("...jde,...rd,...me->...rjm", D1c, Sc, duT))
    d2q[..., 6:, rot] = cross[..., 6:, :]
    d2q[..., rot, 6:] = cross[..., 6:, :].transpose(-1, -2)
    return d2q, d2qd, dvdq, dM


def _per_state(single, q, qd, qdd):
    """``single`` on one state, or vmapped over the flattened batch."""
    if q.dim() == 1:
        return single(q, qd, qdd)
    batch = q.shape[:-1]
    flat = lambda x: x.reshape(-1, x.shape[-1])
    outs = vmap(single)(flat(q), flat(qd), flat(qdd))
    return tuple(o.reshape(batch + o.shape[1:]) for o in outs)


def idsva_so_ad(model: RobotModel, q, qd, qdd, gravity: float = -9.81):
    """The four tensors by forward-mode AD over the analytical first-order
    ``rnea_grad`` (and ``crba`` for dM): exact on branched trees and both
    floating roots.  On the rpy root the six root-pose columns of dtau/dq
    are differentiated through RNEA itself (jacfwd of jacfwd), since
    ``rnea_grad`` builds them from the same closed-form gravity-seed
    derivatives as the native sweep.  On the quaternion root every q
    derivative goes through the retraction at xi = 0
    (``_idsva_so_ad_quat``)."""
    if model.floating_base and model.root_quat:
        return _idsva_so_ad_quat(model, q, qd, qdd, gravity)

    def first_order(q_, qd_, qdd_):
        return torch.stack(rnea_grad(model, q_, qd_, qdd_, gravity,
                                     split=True))

    def root_columns(q_, qd_, qdd_):
        # dtau/dq[:, 0:6] by forward-mode AD of RNEA: (n, 6)
        tau = lambda pose: rnea(model, torch.cat([pose, q_[6:]]), qd_, qdd_,
                                gravity)[0]
        return jacfwd(tau)(q_[:6])

    def single(q_, qd_, qdd_):
        # jacfwd in q of (dc_dq, dc_dqd): (2, n, n, n), the last axis k
        d_dq = jacfwd(first_order, argnums=0)(q_, qd_, qdd_)
        d2tau_dq = d_dq[0]
        if model.floating_base:
            d2tau_dq = torch.cat([jacfwd(root_columns)(q_, qd_, qdd_),
                                  d2tau_dq[:, 6:]], dim=1)
        d2tau_dqd = jacfwd(lambda v: first_order(q_, v, qdd_)[1])(qd_)
        dM = jacfwd(lambda qq: crba(model, qq))(q_)
        return d2tau_dq, d2tau_dqd, d_dq[1], dM

    return _per_state(single, q, qd, qdd)


def _idsva_so_ad_quat(model: RobotModel, q, qd, qdd, gravity: float):
    """The quaternion root's tangent-chart reference: jacfwd of jacfwd of
    RNEA through ``config_retract`` (n^2 tangent evaluations of RNEA a
    state)."""
    from ..solver.integrate import config_retract

    def single(q_, qd_, qdd_):
        z = torch.zeros(model.nv, dtype=q_.dtype, device=q_.device)

        def tau_xi(xi, v, acc):
            return rnea(model, config_retract(model, q_, xi), v, acc,
                        gravity)[0]

        d2tau_dq = jacfwd(jacfwd(tau_xi, argnums=0), argnums=0)(z, qd_, qdd_)
        d2tau_dqd = jacfwd(jacfwd(tau_xi, argnums=1), argnums=1)(z, qd_,
                                                                  qdd_)
        # [i, j, k] = d(dtau_i/dqd_j)/dxi_k
        d2tau_dvdq = jacfwd(jacfwd(tau_xi, argnums=1), argnums=0)(z, qd_,
                                                                   qdd_)
        dM = jacfwd(lambda xi: crba(model, config_retract(model, q_, xi)))(z)
        return d2tau_dq, d2tau_dqd, d2tau_dvdq, dM

    return _per_state(single, q, qd, qdd)


def idsva_so(model: RobotModel, q, qd, qdd, gravity: float = -9.81):
    """Second-order inverse-dynamics derivatives on every root: (..., nq),
    (..., nv), (..., nv) -> four (..., n, n, n) tensors (module header);
    the native sweep."""
    return idsva_so_native(model, q, qd, qdd, gravity)


def fdsva_so(model: RobotModel, q, qd, u, gravity: float = -9.81):
    """Second-order forward-dynamics derivatives: (daba_dqdq, daba_dvdq,
    daba_dvdv, daba_dtdq), each (..., n, n, n):
      daba_dqdq[i,j,k] = d2qdd_i/dq_j dq_k,  daba_dvdv = d2qdd/dqd2,
      daba_dvdq = d2qdd/dqd dq,  daba_dtdq[i,j,k] = d(dqdd_i/dtau_j)/dq_k."""
    Xs = joint_transforms_list(model, q)
    qdd, Minv, fd_dq, fd_dqd = forward_dynamics_full(model, q, qd, u, gravity,
                                                     Xs=Xs)
    d2_dq, d2_dqd, d2_dvdq, dM_dq = idsva_so_native(model, q, qd, qdd,
                                                    gravity, Xs=Xs)

    mmt3 = lambda A, B: torch.einsum("...il,...ljk->...ijk", A, B)
    # tau(q, qd, qdd(q, qd, u)) is identically u, so the second derivative
    # of qdd folds dM_dq against the first-order FD gradients
    t_q = torch.einsum("...ilk,...lj->...ijk", dM_dq, fd_dq)
    daba_dqdq = -mmt3(Minv, d2_dq + t_q + t_q.transpose(-1, -2))
    t_v = torch.einsum("...ilk,...lj->...ijk", dM_dq, fd_dqd)
    daba_dvdq = -mmt3(Minv, d2_dvdq + t_v)
    daba_dvdv = -mmt3(Minv, d2_dqd)
    daba_dtdq = -mmt3(Minv, torch.einsum("...ilk,...lj->...ijk", dM_dq,
                                         Minv))
    return daba_dqdq, daba_dvdq, daba_dvdv, daba_dtdq

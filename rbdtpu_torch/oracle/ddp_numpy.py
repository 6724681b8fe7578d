"""Serial numpy DDP driven by a reference-compatible dynamics object (the
port's copy of ``rbdtpu.oracle.ddp_numpy``): the control-parity oracle.

It mirrors ``solver.ddp``'s math (the same integrator, Riccati recursion
and parallel-step selection rule), but every dynamics quantity comes from
``ref``: any object with the reference's ``forward_dynamics``, ``rnea``,
``minv`` and ``rnea_grad`` (the numpy ``RBDReference``, or
``compat.RBDReferenceTorch``), run serially in float64.  Pair it with
``DDPConfig(rollout_route="minv")``, so that both executions step by the
same algorithm.
"""
from __future__ import annotations

import numpy as np


class NumpyDDP:
    def __init__(self, ref, nq, nv, *, dt=0.01, gravity=-9.81,
                 iters=20, reg_init=1e-6, reg_min=1e-9, reg_max=1e6,
                 reg_up=10.0, reg_down=0.5, n_alphas=8, tol_dJ=1e-12):
        self.ref = ref
        self.nq, self.nv = nq, nv
        self.dt, self.gravity = dt, gravity
        self.iters = iters
        self.reg_init, self.reg_min, self.reg_max = reg_init, reg_min, reg_max
        self.reg_up, self.reg_down = reg_up, reg_down
        self.alphas = 2.0 ** -np.arange(n_alphas)
        self.tol_dJ = tol_dJ

    # --- dynamics through the reference ---
    def fd(self, q, qd, u):
        # the Minv + RNEA route, paired with DDPConfig(rollout_route="minv"):
        # at H=100 x 10 iterations the closed loop amplifies a route
        # mismatch (ABA against the Minv solve, ~1e-13 a step) past the
        # 1e-6 parity budget.  The reference's forward_dynamics takes no
        # gravity, so it is pinned to its default -9.81.
        assert self.gravity == -9.81
        return np.asarray(
            self.ref.forward_dynamics(q.copy(), qd.copy(), u.copy())
        ).ravel()

    def step(self, x, u):
        q, qd = x[: self.nq], x[self.nq:]
        qdd = self.fd(q, qd, u)
        qd2 = qd + self.dt * qdd
        return np.concatenate([q + self.dt * qd2, qd2])

    def step_jac(self, x, u):
        q, qd = x[: self.nq], x[self.nq:]
        c = np.asarray(self.ref.rnea(q.copy(), qd.copy(), None, self.gravity)[0]).ravel()
        Mi = np.asarray(self.ref.minv(q.copy()))
        qdd = Mi @ (u - c)
        grad = np.asarray(self.ref.rnea_grad(q.copy(), qd.copy(), qdd.copy(),
                                             self.gravity))
        dc_dq, dc_dqd = grad[:, : self.nv], grad[:, self.nv:]
        dqdd_dq = -Mi @ dc_dq
        dqdd_dqd = -Mi @ dc_dqd
        n, dt = self.nv, self.dt
        eye = np.eye(n)
        A = np.block([
            [eye + dt * dt * dqdd_dq, dt * eye + dt * dt * dqdd_dqd],
            [dt * dqdd_dq, eye + dt * dqdd_dqd],
        ])
        B = np.concatenate([dt * dt * Mi, dt * Mi], axis=0)
        return A, B

    # --- cost plumbing: the caller's closed-form derivatives, which must
    #     match the torch cost's exactly ---
    def rollout(self, x0, U):
        X = [x0]
        for u in U:
            X.append(self.step(X[-1], u))
        return np.stack(X)

    def solve(self, cost, x0, U0):
        """cost: object with stage(x,u,t), terminal(x), and exact derivative
        methods stage_derivs(x,u,t) -> (lx,lu,lxx,luu,lux) and
        terminal_derivs(x) -> (lfx,lfxx)."""
        U = np.array(U0, dtype=np.float64)
        X = self.rollout(x0, U)
        J = self.traj_cost(cost, X, U)
        reg = self.reg_init
        H = len(U)
        for _ in range(self.iters):
            A = np.zeros((H, 2 * self.nv, 2 * self.nv))
            Bm = np.zeros((H, 2 * self.nv, self.nv))
            for t in range(H):
                A[t], Bm[t] = self.step_jac(X[t], U[t])
            k, K, ok = self.backward(cost, X, U, A, Bm, reg)
            if ok:
                bestJ, bestXU = np.inf, None
                for alpha in self.alphas:
                    Xn, Un = self.forward(X, U, k, K, alpha)
                    Jn = self.traj_cost(cost, Xn, Un)
                    if np.isfinite(Jn) and Jn < bestJ:
                        bestJ, bestXU = Jn, (Xn, Un)
                # deterministic acceptance threshold, mirroring
                # solver.ddp (DDPConfig.tol_dJ): rounding-level improvements
                # must be rejected identically on both executions
                if bestJ < J - self.tol_dJ * max(1.0, abs(J)):
                    X, U = bestXU
                    J = bestJ
                    reg = max(self.reg_min, reg * self.reg_down)
                else:
                    reg = min(self.reg_max, reg * self.reg_up)
            else:
                reg = min(self.reg_max, reg * self.reg_up)
        return X, U, J

    def backward(self, cost, X, U, A, B, reg):
        H = len(U)
        lfx, lfxx = cost.terminal_derivs(X[-1])
        Vx, Vxx = lfx, lfxx
        k = np.zeros_like(U)
        K = np.zeros((H, self.nv, 2 * self.nv))
        eye_u = np.eye(self.nv)
        for t in range(H - 1, -1, -1):
            lx, lu, lxx, luu, lux = cost.stage_derivs(X[t], U[t], t)
            Qx = lx + A[t].T @ Vx
            Qu = lu + B[t].T @ Vx
            Qxx = lxx + A[t].T @ Vxx @ A[t]
            Quu = luu + B[t].T @ Vxx @ B[t]
            Qux = lux + B[t].T @ Vxx @ A[t]
            Quu_reg = Quu + reg * eye_u
            try:
                np.linalg.cholesky(Quu_reg)
            except np.linalg.LinAlgError:
                return k, K, False
            k[t] = -np.linalg.solve(Quu_reg, Qu)
            K[t] = -np.linalg.solve(Quu_reg, Qux)
            Vx = Qx + K[t].T @ Quu @ k[t] + K[t].T @ Qu + Qux.T @ k[t]
            Vxx = Qxx + K[t].T @ Quu @ K[t] + K[t].T @ Qux + Qux.T @ K[t]
            Vxx = 0.5 * (Vxx + Vxx.T)
        return k, K, True

    def forward(self, X, U, k, K, alpha):
        x = X[0]
        Xn, Un = [x], []
        for t in range(len(U)):
            u = U[t] + alpha * k[t] + K[t] @ (x - X[t])
            x = self.step(x, u)
            Un.append(u)
            Xn.append(x)
        return np.stack(Xn), np.stack(Un)

    def traj_cost(self, cost, X, U):
        J = sum(cost.stage(X[t], U[t], t) for t in range(len(U)))
        return J + cost.terminal(X[-1])


class QuadTrackingCostNp:
    """Numpy mirror of ``solver.costs.quadratic_tracking_cost`` (flat
    state difference) with exact derivatives."""

    def __init__(self, nq, nv, x_goal, w_q=1.0, w_qd=0.1, w_u=1e-4,
                 w_q_f=100.0, w_qd_f=10.0):
        self.nq, self.nv = nq, nv
        self.x_goal = np.asarray(x_goal, dtype=np.float64)
        self.w = (w_q, w_qd, w_u, w_q_f, w_qd_f)

    def _split(self, x):
        d = x - self.x_goal
        return d[: self.nq], d[self.nq:]

    def stage(self, x, u, t):
        w_q, w_qd, w_u, _, _ = self.w
        dq, dqd = self._split(x)
        return 0.5 * (w_q * dq @ dq + w_qd * dqd @ dqd + w_u * u @ u)

    def terminal(self, x):
        *_, w_q_f, w_qd_f = self.w
        dq, dqd = self._split(x)
        return 0.5 * (w_q_f * dq @ dq + w_qd_f * dqd @ dqd)

    def stage_derivs(self, x, u, t):
        w_q, w_qd, w_u, _, _ = self.w
        dq, dqd = self._split(x)
        lx = np.concatenate([w_q * dq, w_qd * dqd])
        lu = w_u * u
        lxx = np.diag(
            np.concatenate([np.full(self.nq, w_q), np.full(self.nv, w_qd)])
        )
        luu = w_u * np.eye(self.nv)
        lux = np.zeros((self.nv, self.nq + self.nv))
        return lx, lu, lxx, luu, lux

    def terminal_derivs(self, x):
        *_, w_q_f, w_qd_f = self.w
        dq, dqd = self._split(x)
        lfx = np.concatenate([w_q_f * dq, w_qd_f * dqd])
        lfxx = np.diag(
            np.concatenate([np.full(self.nq, w_q_f), np.full(self.nv, w_qd_f)])
        )
        return lfx, lfxx

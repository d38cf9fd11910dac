"""Q1 finite-element kit on the structured grid.

Rebuild of PISM's FEM toolkit (``src/util/fem/`` — ``Quadrature``,
``Element``/``ElementMap``, shape functions) for the SSAFEM stress balance,
re-designed for XLA: instead of a per-element assembly loop with local
gather/scatter, every element quantity is a whole-(My, Mx) array (entry
(j, i) = the element whose lower-left node is (j, i)), corner values are
``jnp.roll`` shifts of the nodal arrays (so periodic grids wrap exactly
like PISM's element map), and the scatter of element contributions back to
nodes is four rolled adds. On non-periodic axes the wrap row/column of
elements is masked out by :func:`element_validity`. Everything fuses into a
handful of fused kernels; under a device mesh the rolls become GSPMD
collective-permutes exactly like the FD stencils.

Reference square [-1,1]^2, node order a = 0..3: (-1,-1), (1,-1), (1,1),
(-1,1); N_a = (1 + xi_a xi)(1 + eta_a eta)/4; 2x2 Gauss points at
+-1/sqrt(3) with unit weights; uniform rectangular elements (dx, dy) give
the constant Jacobian J = dx dy / 4.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

#: local node coordinates on the reference square
_XI_A = np.array([-1.0, 1.0, 1.0, -1.0])
_ETA_A = np.array([-1.0, -1.0, 1.0, 1.0])
#: 2x2 Gauss points (unit weights)
_G = 1.0 / np.sqrt(3.0)
_XI_Q = np.array([-_G, _G, _G, -_G])
_ETA_Q = np.array([-_G, -_G, _G, _G])

#: N[a][q], dNdxi[a][q], dNdeta[a][q] — python-float tables, baked into the
#: traced expressions as constants
N_TAB = [[float(0.25 * (1 + _XI_A[a] * _XI_Q[q]) * (1 + _ETA_A[a] * _ETA_Q[q]))
          for q in range(4)] for a in range(4)]
DNDXI_TAB = [[float(0.25 * _XI_A[a] * (1 + _ETA_A[a] * _ETA_Q[q]))
              for q in range(4)] for a in range(4)]
DNDETA_TAB = [[float(0.25 * _ETA_A[a] * (1 + _XI_A[a] * _XI_Q[q]))
               for q in range(4)] for a in range(4)]

#: (dy_shift, dx_shift) of local node a relative to the element origin
_NODE_SHIFT = [(0, 0), (0, 1), (1, 1), (1, 0)]


def corners(u):
    """Nodal (My, Mx) -> 4 element-corner arrays of shape (My, Mx), in
    local node order; the east/north neighbors wrap (mask the wrap
    row/column with :func:`element_validity` on non-periodic axes)."""
    e = jnp.roll(u, -1, axis=1)
    n = jnp.roll(u, -1, axis=0)
    ne = jnp.roll(e, -1, axis=0)
    return (u, e, ne, n)


def element_validity(shape, periodic_x: bool, periodic_y: bool,
                     dtype=jnp.float64):
    """1 on real elements, 0 on the wrap row/column of non-periodic axes."""
    v = np.ones(shape, dtype=np.float64)
    if not periodic_x:
        v[:, -1] = 0.0
    if not periodic_y:
        v[-1, :] = 0.0
    return jnp.asarray(v, dtype)


def quad_values(u_c):
    """Element corners -> values at the 4 quadrature points:
    list of 4 (My, Mx) arrays."""
    return [sum(N_TAB[a][q] * u_c[a] for a in range(4)) for q in range(4)]


def quad_gradients(u_c, dx: float, dy: float):
    """Element corners -> (du/dx, du/dy) at the 4 quadrature points."""
    sx, sy = 2.0 / dx, 2.0 / dy
    gx = [sx * sum(DNDXI_TAB[a][q] * u_c[a] for a in range(4))
          for q in range(4)]
    gy = [sy * sum(DNDETA_TAB[a][q] * u_c[a] for a in range(4))
          for q in range(4)]
    return gx, gy


def scatter_to_nodes(contrib_a):
    """Sum per-(element, local node) contributions into the nodal array:
    the transpose of :func:`corners` (rolled adds; wrap contributions are
    zero when the caller masked with :func:`element_validity`)."""
    out = contrib_a[0]
    out = out + jnp.roll(contrib_a[1], 1, axis=1)
    out = out + jnp.roll(jnp.roll(contrib_a[2], 1, axis=0), 1, axis=1)
    out = out + jnp.roll(contrib_a[3], 1, axis=0)
    return out


def integrate(test_terms, dx: float, dy: float):
    """Assemble sum_q w_q J [ f0_q N_a + fx_q dN_a/dx + fy_q dN_a/dy ]
    into a nodal residual array.

    test_terms: (f0, fx, fy), each a list of 4 quad-point element arrays
    (or None). This is the weak-form integral of
    f0 * phi + fx * phi_x + fy * phi_y over the domain, for every Q1 test
    function phi at once. The caller masks invalid (wrap) elements inside
    the coefficient arrays.
    """
    f0, fx, fy = test_terms
    J = dx * dy / 4.0
    sx, sy = 2.0 / dx, 2.0 / dy
    contrib = []
    for a in range(4):
        acc = 0.0
        for q in range(4):
            term = 0.0
            if f0 is not None:
                term = term + f0[q] * N_TAB[a][q]
            if fx is not None:
                term = term + fx[q] * (sx * DNDXI_TAB[a][q])
            if fy is not None:
                term = term + fy[q] * (sy * DNDETA_TAB[a][q])
            acc = acc + term
        contrib.append(J * acc)
    return scatter_to_nodes(contrib)

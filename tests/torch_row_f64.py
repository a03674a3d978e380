"""The row-layout horseshoe sweep's plain step in float64: the yardstick
of tests/test_torch_jacobi_row.py (plain version and JAX) and
tests/test_torch_cuda.py (kernel and plain version) at shapes where the
f32 sides part by more than f32 reassociation alone."""
import torch

from bayesrrcpp_tpu_torch.ops import genotypes

# each f32 side of the row horseshoe at (J, B, nr) = (16, 512, 2), N=1,500
# against the float64 step, elementwise: ~2.3x (beta) and ~2.8x (eps) the
# largest distance of the plain version and of JAX's kernel in interpret
# mode over 8 lam draws on the CPU (8.8e-6 and 7.2e-4)
ROW_HS_F64_ATOL = {"beta": 2e-5, "eps": 2e-3}


def row_hs_f64(args, kw):
    """A row horseshoe sweep's plain step in float64 on the same operands
    (the words decoded, or the dense rows): (eps, beta).  The yardstick
    that the kernel, the plain f32 version and JAX's kernel are each held
    to where they part (the row horseshoe at N=1,500)."""
    (words, gram, xsq, eps, beta, border, inner, z, lam, tau, c2, sE,
     valid) = args
    f64, J = torch.float64, kw["J"]
    B = gram.shape[1]
    dev = words.device
    if kw.get("x_mean") is None:
        X = words.to(f64)
    else:
        X = ((genotypes.decode_codes(words).to(f64)
              - kw["x_mean"].to(f64)[:, None])
             * kw["x_scale"].to(f64)[:, None]) * kw["row_valid"].to(f64)
    xsq, lam, z, gram = (t.to(f64) for t in (xsq, lam, z, gram))
    tau, c2, sE = (float(t) for t in (tau, c2, sE))
    s_j = tau * c2 * lam / (tau * lam + c2)
    denom = xsq + sE / s_j
    invd, sd = 1.0 / denom, torch.sqrt(sE / denom)
    ok = valid.to(f64)
    eps, beta = eps.to(f64).clone(), beta.to(f64).clone()
    jj = torch.arange(J, device=dev)
    lanes = torch.arange(B, device=dev)
    for r in range(border.shape[0] // J):
        blk = border[r * J:(r + 1) * J].long()
        rows = (blk[:, None] * B + lanes).reshape(-1)
        rr = (X[rows] @ eps).view(J, B)
        d = torch.zeros((J, B), dtype=f64, device=dev)
        for s in range(B):
            m = inner[blk, s].long()
            g = blk * B + m
            num = rr[jj, m] + beta[g] * xsq[g]
            dd = ok[g] * (num * invd[g] + sd[g] * z[(r * J + jj) * B + s]
                          - beta[g])
            rr = rr - gram[blk, m, :] * dd[:, None]
            d[jj, m] = dd
        beta[rows] += d.reshape(-1)
        eps = eps - d.reshape(-1) @ X[rows]
    return eps, beta

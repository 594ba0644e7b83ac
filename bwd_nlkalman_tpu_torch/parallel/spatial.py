"""Row-sharded NL-Kalman passes with halo exchange over a :class:`Mesh`.

Port of ``bwd_nlkalman_tpu.parallel.spatial``. A frame's rows are split
over the mesh's 'sp' axis. Each shard:

1. takes ``halo`` rows from each neighbour (``_halo_extend``: the
   previous shard's last rows above, the next shard's first rows below,
   moved with ``Tensor.to`` to its device; edge shards take zeros, which
   the global bounds keep out of every group);
2. runs one NLK pass on its extended block for the stride-psz/2 sites it
   owns (``site_rows``), with candidates kept to the GLOBAL patch rows
   (``qy_bounds``), and keeps the sums before the normalisation
   (``return_accum``): K1 on CUDA tensors, the plain pass on CPU tensors;
3. sends its halo rows of those sums back to their owners
   (``_halo_fold``), and
4. normalises its own rows.

That reproduces the whole frame's pass up to the order of the fold's
sums. A batch (B, H, W, C) runs clip k*B/dp .. (k+1)*B/dp - 1 on batch
row k of the mesh. One process drives every shard, as JAX's shard_map
is driven by one controller; the results come back whole on the mesh's
first device.
"""

from __future__ import annotations

import torch

from .._dispatch import check_engine, check_window_dtype
from ..core.engine import dense_pass, nlk_bases
from ..core.engine_cuda import pass_radius
from ..core.nlkalman import _prepare, k1_supported, pick_engine
from ..ops.bases import make_bases
from ..ops.color import opp2rgb, rgb2opp
from ..params import NLKParams
from .flow import sharded_warp
from .mesh import Mesh


def _halo_extend(blocks, halo):
    """Per-shard (rows, ...) blocks -> (rows + 2*halo, ...) blocks with
    their neighbours' rows (zeros at the frame's edges)."""
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        top = blocks[i - 1][-halo:].to(x.device) if i > 0 else torch.zeros_like(x[:halo])
        bot = blocks[i + 1][:halo].to(x.device) if i < n - 1 else torch.zeros_like(x[:halo])
        out.append(torch.cat([top, x, bot]))
    return out


def _halo_fold(accs, halo):
    """Per-shard extended sums -> each shard's own rows, with the halo rows
    its neighbours summed for it added in (the previous shard's bottom
    halo onto its first rows, then the next shard's top halo onto its
    last)."""
    n = len(accs)
    out = []
    for i, a in enumerate(accs):
        own = a[halo:-halo].clone()
        if i > 0:
            own[:halo] += accs[i - 1][-halo:].to(a.device)
        if i < n - 1:
            own[-halo:] += accs[i + 1][:halo].to(a.device)
        out.append(own)
    return out


def shard_bounds(i: int, block: int, halo: int, global_h: int, psz: int):
    """(site_rows, qy_bounds) of shard i's pass over its extended block:
    its own site rows, and the global patch rows 0 .. global_h - psz in
    the block's coordinates (local row = global row - i*block + halo)."""
    step = psz // 2
    g0 = i * block
    return ((halo // step, (halo + block) // step),
            (halo - g0, global_h - psz + 1 + halo - g0))


def _sharded_pass_body(cur, prev, pvalid, basic, sigma, prms, mode, has_prev,
                       has_basic, halo, global_h, engine, window_dtype, bases):
    """One sharded pass over per-shard row blocks (lists, shard i on its
    device): JAX's shard_map body (spatial.py:66-131) for every shard.
    ``bases`` maps each shard's device to its constants. Returns each
    shard's normalised own rows."""
    psz = prms.patch_sz
    block = cur[0].shape[0]
    cur_e = _halo_extend(cur, halo)
    basic_e = _halo_extend(basic, halo) if has_basic else cur_e
    if has_prev:
        prev_e = _halo_extend(prev, halo)
        pval_e = _halo_extend(pvalid, halo)
    else:
        prev_e = [torch.zeros_like(c) for c in cur_e]
        pval_e = [torch.zeros(c.shape[:2], dtype=torch.bool, device=c.device)
                  for c in cur_e]
    outs, aggs = [], []
    for i, (c, p, v, b) in enumerate(zip(cur_e, prev_e, pval_e, basic_e)):
        site_rows, qy_bounds = shard_bounds(i, block, halo, global_h, psz)
        out, agg = dense_pass(
            c, p, v, b, sigma, prms, mode, has_prev, has_basic,
            engine=pick_engine(engine, c, prms, mode, window_dtype),
            bases=bases[c.device], window_dtype=window_dtype,
            site_rows=site_rows, qy_bounds=qy_bounds, return_accum=True)
        outs.append(out)
        aggs.append(agg)
    outs, aggs = _halo_fold(outs, halo), _halo_fold(aggs, halo)
    return [torch.where((a > 1e-6)[..., None], o / torch.clamp(a, min=1e-6)[..., None], c)
            for o, a, c in zip(outs, aggs, cur)]


def resolve_engine(local_h: int, w: int, ch: int, prms: NLKParams, mode: str,
                   device, window_dtype: str = "float32") -> str:
    """The engine a shard's pass runs on, for callers that report it: "k1"
    on a CUDA device where K1 takes a pass over the halo-extended block
    of ``local_h`` rows, else "plain" (JAX's "pallas" / "v2",
    spatial.py:134-158)."""
    if torch.device(device).type == "cuda" and k1_supported(local_h, w, ch, prms, mode,
                                                             window_dtype):
        return "k1"
    return "plain"


def shard_halo(prms: NLKParams, mode: str) -> int:
    """Rows a shard takes from each neighbour: the search radius plus a
    patch, rounded up to the site stride so that every shard's sites stay
    on the global grid."""
    step = prms.patch_sz // 2
    return -(-(pass_radius(prms, mode) + prms.patch_sz) // step) * step


def _shard_bases(bases, devices, psz: int) -> dict:
    """Device -> the constants of a pass at patch size ``psz``: the caller's
    ``bases`` on their own device, built once in the call for every other
    device of ``devices``."""
    own = next(iter(bases.values())).device if bases else None
    return {d: bases if d == own else make_bases(nlk_bases(psz), d)
            for d in dict.fromkeys(devices)}


def _spatial_pass(cur, prev, pvalid, basic, sigma, prms, mode, has_prev,
                  has_basic, mesh: Mesh, *, engine: str = "auto", bases=None,
                  window_dtype: str = "float32"):
    """Row-sharded NL-Kalman pass of (H, W, C) frames (on batch row 0 of the
    mesh) or (B, H, W, C) batches (clips over 'dp', rows over 'sp'); the
    result whole on the mesh's first device. ``bases`` (``ops.bases``)
    serve the shards on their device; the shards elsewhere get theirs
    built in the call. JAX's ``chunk_sites``, a memory knob of its plain
    pass, has no counterpart: the arguments after ``mesh`` are keywords."""
    check_engine(engine)
    check_window_dtype(window_dtype)
    batched = cur.ndim == 4
    h = cur.shape[1] if batched else cur.shape[0]
    n_sp, n_dp = mesh.shape["sp"], mesh.shape["dp"]
    step = prms.patch_sz // 2
    halo = shard_halo(prms, mode)
    if h % n_sp:
        raise ValueError(f"H={h} not divisible by sp={n_sp}")
    block = h // n_sp
    if block % step:
        raise ValueError(f"shard block {block} rows not divisible by {step}")
    if block < halo:
        raise ValueError(f"shard block {block} rows < halo {halo}; reduce sp")
    if batched and cur.shape[0] % n_dp:
        raise ValueError(f"batch {cur.shape[0]} not divisible by dp={n_dp}")

    rows_used = mesh.devices if batched else mesh.devices[:1]
    consts = _shard_bases(bases, [d for row in rows_used for d in row], prms.patch_sz)

    def one(k, c, p, v, b):
        def rows(x):
            return [x[i * block:(i + 1) * block].to(d).contiguous()
                    for i, d in enumerate(mesh.devices[k])]

        own = _sharded_pass_body(
            rows(c), rows(p) if has_prev else None, rows(v) if has_prev else None,
            rows(b) if has_basic else None, sigma, prms, mode, has_prev, has_basic,
            halo, h, engine, window_dtype, consts)
        return torch.cat([o.to(mesh.first) for o in own])

    if not batched:
        return one(0, cur, prev, pvalid, basic)
    per = cur.shape[0] // n_dp
    return torch.stack([one(j // per, cur[j], prev[j], pvalid[j], basic[j])
                        for j in range(cur.shape[0])])


def spatial_filter_frame(nisy, deno0, prev_valid, bsic1, sigma, prms: NLKParams,
                         mesh: Mesh, *, engine: str = "auto", bases=None,
                         window_dtype: str = "float32"):
    """Row-sharded ``nlkalman_filter_frame`` (OPP-space inputs), the same
    result up to the order of the fold's sums."""
    has_prev, has_basic = deno0 is not None, bsic1 is not None
    deno0, prev_valid = _prepare(nisy, deno0, prev_valid)
    return _spatial_pass(nisy, deno0, prev_valid, bsic1 if has_basic else nisy,
                         float(sigma), prms, "filter", has_prev, has_basic, mesh,
                         engine=engine, bases=bases, window_dtype=window_dtype)


def spatial_smooth_frame(filt1, smoo0, prev_valid, sigma, prms: NLKParams,
                         mesh: Mesh, *, engine: str = "auto", bases=None,
                         window_dtype: str = "float32"):
    """Row-sharded ``nlkalman_smooth_frame``."""
    has_prev = smoo0 is not None
    smoo0, prev_valid = _prepare(filt1, smoo0, prev_valid)
    return _spatial_pass(filt1, smoo0, prev_valid, filt1, float(sigma), prms,
                         "smooth", has_prev, False, mesh, engine=engine, bases=bases,
                         window_dtype=window_dtype)


def sharded_filter_step(mesh: Mesh, sigma: float, p1: NLKParams, p2: NLKParams,
                        engine: str = "auto", window_dtype: str = "float32"):
    """The batched two-pass filter step over a ('dp', 'sp') mesh (JAX
    spatial.py:258-297): ``step(noisy, flt1_prev, flt2_prev, flow, occ) ->
    (flt1, flt2)`` for (B, H, W, C) batches, flow (B, H, W, 2) and occlusion
    masks (B, H, W) (nonzero = occluded). Each clip's warps run row-sharded
    over the 'sp' devices of its batch row (K4's shard form on the card,
    ``parallel/flow.py``); both NLK passes are sharded."""
    def warp(prevs, flow, occ):
        per = prevs.shape[0] // mesh.shape["dp"]
        ws, vs = [], []
        for j in range(prevs.shape[0]):
            k = j // per
            d = mesh.devices[k][0]
            w, v = sharded_warp(rgb2opp(prevs[j].to(d)), flow[j].to(d), occ[j].to(d), mesh,
                                engine, row=k)
            ws.append(torch.where(v[..., None], w, 0.0).to(mesh.first))
            vs.append(v.to(mesh.first))
        return torch.stack(ws), torch.stack(vs)

    @torch.no_grad()
    def step(noisy, flt1_prev, flt2_prev, flow, occ):
        if noisy.shape[0] % mesh.shape["dp"]:
            raise ValueError(f"batch {noisy.shape[0]} not divisible by "
                             f"dp={mesh.shape['dp']}")
        n_opp = rgb2opp(noisy)
        w1, v1 = warp(flt1_prev, flow, occ)
        kw = dict(engine=engine, window_dtype=window_dtype)
        f11 = _spatial_pass(n_opp, w1, v1, n_opp, float(sigma), p1, "filter", True,
                            False, mesh, **kw)
        w2, v2 = warp(flt2_prev, flow, occ)
        f21 = _spatial_pass(n_opp, w2, v2, f11, float(sigma), p2, "filter", True,
                            True, mesh, **kw)
        return opp2rgb(f11), opp2rgb(f21)

    return step

"""Command-line interface of the port (counterpart of ``metadyn_tpu/cli.py``):

    python -m metadyn_tpu_torch.cli run config.yaml [--resume] [--device cpu]
    python -m metadyn_tpu_torch.cli sum-hills HILLS [--blocks N] ...
    python -m metadyn_tpu_torch.cli fes grid.npz ...
    python -m metadyn_tpu_torch.cli rdf traj.gsd ...

``run`` reads the reference's YAML schema (``io/config.py``, no PyYAML) and
drives one replica (or, with ``metadynamics.n_walkers`` W > 1, W walkers
sharing one bias, all on the one device: ``parallel/walkers.py``, or the
flux sampler's walker mode) on the packed engine (with an integer
``engine.spatial_devices`` > 1 on ``parallel/spatial.SpatialPackedEngine``,
the x-slab decomposition, and with a list ``[nx, ny]`` on
``parallel/spatial2d.SpatialPackedEngine2D``, the 2-D decomposition: its
shards on the visible cards in turn under CUDA, shared when fewer than
the shards, virtual shards of the CPU under ``--device cpu``; with walkers
too, the walkers × space product, ``nested=True``; with
``engine.nbr_table: [r_nb, K]`` the single-grid engine keeps the slot
neighbour table of the order CVs) or, with ``engine.kind:
all_pairs``, on the particle-order all-pairs engine: inits ``fcc``, ``sc``
and ``melt`` (with the push-off of ``init.prerelax_steps``, ``core/
pushoff.prerelax_melt``), tilted boxes, diblock types and per-type-pair
tables, FENE or harmonic bonds, the LJ, WCA and soft pairs; the lamellar,
mesh (under ``spatial_devices`` the distributed slab-FFT ``parallel/
mesh.ShardedPackedMesh``, under a list the pencil-FFT ``parallel/
mesh2d.ShardedPackedMesh2D``), Q6, coordination, MSD and aspect-ratio CVs
(all-pairs: lamellar, mesh, Steinhardt Q_l and MSD by autograd, and the
aspect ratio) and the well-tempered ensemble's energy CV (``kind: wte``,
which turns on the packed engine's energy at every force call, as
``npt_scr`` does); Langevin, NVE and SCR-NPT (``npt_scr``, isotropic or
anisotropic, with ``box_bias`` the box-shape metadynamics of the aspect
ratio; all-pairs: Langevin, Nosé–Hoover ``nvt_nh``, ``nvt_bdp`` and
``npt_scr``); standard, well-tempered and flux-tempered metadynamics, with
``restart_from_grid``, edge walls, ``add_hills``, ``bias_every`` and
``mts_lag``; and, where a CV has no ``grid``, the hill-list mode (hill
widths from each CV's ``sigma``, ``metadynamics.hill_capacity``, walls
from each CV's ``wall: {min, max}``).  Its outputs are the reference's
files: the hill log, the CSV metrics, grid dumps (also every
``grid_every`` steps, ``{step}`` in the name numbering them; none in
hill-list mode, which has no grid), checkpoints (every
``checkpoint_every`` steps; ``--resume`` loads one and runs ``n_steps``
more) and, for the all-pairs engine, trajectory frames (``.gsd`` through
the native writer of ``io/gsd_file.py``, ``.dcd`` or npz,
``io/trajectory.py``) at every report, each frame with the leg's step
count (a ``--resume`` leg counts from 0, as in the reference); like the
reference's, a packed run writes no frames.  It runs on CUDA unless
``--device cpu`` is given, and exits with an error when no CUDA device is
found: it never falls back to the CPU.  What the reference refuses raises
its ValueError.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

def _assign_order(c: dict) -> int:
    """Mesh-CV assignment window: ``assign: cic`` (default, order 2) or
    ``tsc`` (order 3)."""
    name = str(c.get("assign", "cic")).lower()
    try:
        return {"cic": 2, "tsc": 3}[name]
    except KeyError:
        raise ValueError(f"cvs.assign must be cic or tsc, got {name!r}")


def _build_packed_cvs(cvs_cfg, spec, n: int, types, n_types: int, device,
                      pos, shards=None, box_L=None, blocks=None):
    """The packed CVs and their per-particle attrs (lamellar and mesh
    coefficients from ``mode``, one per type; the MSD's reference
    positions).  With ``shards`` (the slab engine's devices) the mesh CV is
    the distributed slab-FFT ``ShardedPackedMesh``; with ``blocks`` (the
    2-D engine's devices and shape) the pencil-FFT
    ``ShardedPackedMesh2D``."""
    from .cv.aspect_ratio import AspectRatio
    from .cv.packed import (
        PackedLamellar, PackedMesh, PackedMSD, msd_reference_attrs,
    )
    from .cv.packed_order import PackedCoordination, PackedSteinhardtQl
    from .cv.simple import PotentialEnergyCV
    from .parallel.mesh import ShardedPackedMesh
    from .parallel.mesh2d import ShardedPackedMesh2D

    cvs, extra_attrs = [], {}
    for c in cvs_cfg:
        kind = c["kind"]
        if kind == "lamellar":
            cv = PackedLamellar.create([c["lattice_vector"]], n, device,
                                       name=c["name"])
        elif kind == "mesh" and blocks is not None:
            cv = ShardedPackedMesh2D.create(
                tuple(c["mesh"]), spec, *blocks, n_real=n, k0=c["k0"],
                width=c.get("width", 0.5), box_L=box_L, name=c["name"],
                assign_order=_assign_order(c))
        elif kind == "mesh" and shards is not None:
            cv = ShardedPackedMesh.create(
                tuple(c["mesh"]), spec, shards, n_real=n, k0=c["k0"],
                width=c.get("width", 0.5), box_L=box_L, name=c["name"],
                assign_order=_assign_order(c))
        elif kind == "mesh":
            cv = PackedMesh.create(tuple(c["mesh"]), None, n_real=n,
                                   k0=c["k0"], width=c.get("width", 0.5),
                                   name=c["name"],
                                   assign_order=_assign_order(c))
        elif kind in ("steinhardt", "q6"):
            cv = PackedSteinhardtQl(spec, r_cut=float(c["r_cut"]),
                                    l=int(c.get("l", 6)), name=c["name"])
        elif kind == "coordination":
            cv = PackedCoordination(
                spec, r0=float(c["r0"]), name=c["name"],
                r_cut=float(c["r_cut"]) if "r_cut" in c else None)
        elif kind == "msd":
            cv = PackedMSD(n_real=n, name=c["name"])
            extra_attrs.update(msd_reference_attrs(pos))
        elif kind == "aspect_ratio":
            cv = AspectRatio(axis_a=int(c.get("axis_a", 0)),
                             axis_b=int(c.get("axis_b", 1)), name=c["name"])
        elif kind == "wte":
            cv = PotentialEnergyCV(name=c["name"])
        else:
            raise ValueError(f"unknown packed cv kind {kind}")
        if kind in ("lamellar", "mesh"):
            extra_attrs[cv.attr_name] = np.asarray(
                c.get("mode", [1.0] * n_types), np.float32)[types]
        cvs.append(cv)
    return cvs, extra_attrs


def _build_particle_cvs(cvs_cfg, system, L, device, pos):
    """The particle-order CVs: lamellar, mesh, Steinhardt Q_l and the MSD
    from the start positions (their bias forces by autograd), the aspect
    ratio and the energy CV."""
    from .cv.aspect_ratio import AspectRatio
    from .cv.lamellar import LamellarOP
    from .cv.mesh import MeshOrderParameter
    from .cv.msd import MSD
    from .cv.simple import PotentialEnergyCV
    from .cv.steinhardt import SteinhardtQl

    cvs = []
    for c in cvs_cfg:
        kind = c["kind"]
        mode = c.get("mode", [1.0] * system.n_types)
        if kind == "lamellar":
            cvs.append(LamellarOP.create(
                mode=mode, lattice_vectors=[c["lattice_vector"]],
                name=c["name"], device=device))
        elif kind == "mesh":
            cvs.append(MeshOrderParameter.create(
                tuple(c["mesh"]), L, mode=mode, k0=c["k0"],
                width=c.get("width", 0.5), name=c["name"],
                assign_order=_assign_order(c), device=device))
        elif kind == "steinhardt":
            cvs.append(SteinhardtQl(r_cut=c["r_cut"], l=c.get("l", 6),
                                    name=c["name"]))
        elif kind == "msd":
            cvs.append(MSD.create(pos, name=c["name"], device=device))
        elif kind == "aspect_ratio":
            cvs.append(AspectRatio(axis_a=int(c.get("axis_a", 0)),
                                   axis_b=int(c.get("axis_b", 1)),
                                   name=c["name"]))
        elif kind == "wte":
            cvs.append(PotentialEnergyCV(name=c["name"]))
        else:
            raise ValueError(f"unknown cv kind {kind}")
    return cvs


def _check_wte(cvs, cvs_cfg) -> None:
    """The reference's rule: the energy CV's bias force is analytic, so
    every CV beside it needs an analytic bias force too."""
    if any(c["kind"] == "wte" for c in cvs_cfg) and not all(
            hasattr(cv, "accum_bias_force") or c["kind"] == "wte"
            for cv, c in zip(cvs, cvs_cfg)):
        raise AssertionError(
            "wte (energy CV) needs every co-registered CV to provide an "
            "analytic bias force — combine it with packed CVs or use it "
            "alone")


def _grid_from_cfg(cvs_cfg, device):
    """The bias grid, or None (hill-list mode) where a CV has no grid."""
    from .bias.grid import GridSpec
    if not all("grid" in c for c in cvs_cfg):
        return None
    return GridSpec.create(
        [c["grid"]["min"] for c in cvs_cfg],
        [c["grid"]["max"] for c in cvs_cfg],
        [c["grid"]["num_points"] for c in cvs_cfg],
        [c["grid"]["sigma"] for c in cvs_cfg], device,
        periodic=[bool(c["grid"].get("periodic", False)) for c in cvs_cfg])


def _integrator_factory(icfg: dict, system, packed: bool, spec=None,
                        engine=None):
    """The integrator factory: one argument, ``factory(force_fn)``, or for
    ``npt_scr`` with ``box_bias`` two, ``factory(force_fn, bias)``: the
    box-shape metadynamics of an ``AspectRatio`` (axes 0 and 1, as the
    reference's CLI builds it) through ``box_bias_fn``."""
    from .cv.aspect_ratio import AspectRatio, box_bias_fn_for
    from .integrate.langevin import make_langevin_step
    from .integrate.npt import make_npt_scr_step
    from .integrate.nvt import make_nvt_bdp_step, make_nvt_nh_step
    from .integrate.packed import (
        make_packed_langevin_step, make_packed_npt_scr_step,
        make_packed_nve_step,
    )
    kind = icfg.get("kind", "langevin")
    dt = float(icfg["dt"])
    kT = float(icfg.get("kT", 1.0))
    if kind == "npt_scr":
        kw = dict(dt=dt, kT=kT, pressure=float(icfg["pressure"]),
                  gamma=float(icfg.get("gamma", 1.0)),
                  tau_p=float(icfg.get("tau_p", 2.0)),
                  anisotropic=bool(icfg.get("anisotropic", False)),
                  kappa=float(icfg.get("kappa", 0.1)))
        if packed:
            def make(f, **extra):
                return make_packed_npt_scr_step(f, spec, engine=engine,
                                                **kw, **extra)
        else:
            def make(f, **extra):
                return make_npt_scr_step(f, system, **kw, **extra)
        if bool(icfg.get("box_bias", False)):
            return lambda f, bias: make(
                f, box_bias_fn=box_bias_fn_for(AspectRatio(), bias))
        return make
    if packed:
        if kind == "langevin":
            return lambda f: make_packed_langevin_step(
                f, dt=dt, kT=kT, gamma=float(icfg.get("gamma", 1.0)))
        if kind == "nve":
            return lambda f: make_packed_nve_step(f, dt=dt)
        raise ValueError(f"packed engine supports langevin/nve/npt_scr, "
                         f"got {kind}")
    if kind == "langevin":
        return lambda f: make_langevin_step(
            f, system, dt=dt, kT=kT, gamma=float(icfg.get("gamma", 1.0)))
    if kind == "nvt_nh":
        return lambda f: make_nvt_nh_step(
            f, system, dt=dt, kT=kT, tau=float(icfg.get("tau", 0.5)))
    if kind == "nvt_bdp":
        return lambda f: make_nvt_bdp_step(
            f, system, dt=dt, kT=kT, tau=float(icfg.get("tau", 0.5)))
    raise ValueError(f"unknown integrator kind {kind}")


def _initial_positions(cfg: dict, kT: float, device):
    """(pos, L, bonds) of ``system.init``; a melt with ``prerelax_steps``
    is pushed off first (``core/pushoff.prerelax_melt``, the generator
    seeded with ``init.seed + 99`` as the reference's key)."""
    from .core.pushoff import prerelax_melt
    from .utils import lattice

    init = cfg["system"]["init"]
    kind = init["kind"]
    if kind == "fcc":
        return (lattice.fcc_lattice(init["n_cells"], init["a"]),
                init["n_cells"] * init["a"], None)
    if kind == "sc":
        return (lattice.sc_lattice(init["n_per_side"], init["spacing"]),
                init["n_per_side"] * init["spacing"], None)
    if kind != "melt":
        raise ValueError(f"unknown init kind {kind}")
    L = init["box_L"]
    pos, bonds = lattice.polymer_melt(init["n_chains"], init["chain_len"], L,
                                      seed=init.get("seed", 0))
    prerelax = int(init.get("prerelax_steps", 0))
    if prerelax:
        fene0 = cfg["engine"].get("fene", {"k": 30.0, "r0": 1.5})
        pos = prerelax_melt(pos, bonds, float(L), device, prerelax, kT,
                            seed=int(init.get("seed", 0)) + 99,
                            fene_k=float(fene0["k"]),
                            fene_r0=float(fene0["r0"]))
    return pos, L, bonds


def _check_start_in_grid(cvs, cvs_cfg, grid, state, system) -> None:
    """A start far outside the bias grid means clamped deposits and, with
    walls, huge forces from the first step: refuse it at build time, as the
    reference does (a margin of 5% of the range)."""
    lo = grid.lo.cpu().numpy().astype(np.float64)
    hi = grid.hi.cpu().numpy().astype(np.float64)
    for d, (cv, c) in enumerate(zip(cvs, cvs_cfg)):
        if c["kind"] == "wte":
            # its value needs a force pass that has not run yet
            continue
        v = float(cv.value(state, system))
        margin = 0.05 * (hi[d] - lo[d])
        if v < lo[d] - margin or v > hi[d] + margin:
            raise ValueError(
                f"initial value of CV '{c['name']}' is {v:.6g}, outside "
                f"its bias grid [{lo[d]:g}, {hi[d]:g}]. Deposits would "
                f"clamp to the edge node and walls (wall_k) would apply "
                f"huge forces from step 1 — fix grid.min/max for this "
                f"CV (or its normalization).")


def _spatial_devices(n: int, device) -> list:
    """The shards' devices: under CUDA the visible cards in turn, shard k on
    card k mod (cards), so fewer cards than shards share them, as the
    reference runs more shards than chips on its virtual devices (a note
    on stderr says so); ``n`` virtual shards of the CPU otherwise."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        print(f"note: engine.spatial_devices={n} on {have} visible "
              "card(s): the shards share them", file=sys.stderr)
    return [torch.device("cuda", i % have) for i in range(n)]


def build_sampler(cfg: dict, resume: bool = False, device="cuda"):
    """The sampler a config describes, on ``device``.  Returns
    (sampler, cfg)."""
    from .bias.metad import HillSpec, WallSpec
    from .core.batch import stack_walkers
    from .core.box import Box
    from .core.engine import AllPairsEngine
    from .core.packed_engine import PackedEngine
    from .core.state import make_state, make_system
    from .flux_sampler import FluxTemperedSampler
    from .io.grid_file import load_grid
    from .ops.packed import PackedSpec, bond_partner_attrs, pair_scale_tables
    from .ops.pairs import (
        lj_kernel, lj_tables, soft_kernel, soft_tables, wca_tables,
    )
    from .parallel.walkers import WalkerSampler
    from .sampler import MetadSampler

    sys_cfg = cfg["system"]
    icfg = cfg["integrator"]
    kT = float(icfg.get("kT", 1.0))
    out_cfg = cfg.get("output", {})

    # --- initial configuration -------------------------------------------
    pos, L, bonds = _initial_positions(cfg, kT, device)
    n = pos.shape[0]
    tilt = sys_cfg.get("tilt")
    if tilt is not None:
        xy, xz, yz = (float(t) for t in tilt)
        box = Box.triclinic(float(L), float(L), float(L), device, xy, xz, yz)
    else:
        box = Box.cubic(float(L), device)
    tcfg = sys_cfg.get("types", None)
    if tcfg == "diblock":
        # the first half of each chain A (0), the second half B (1)
        cl = int(sys_cfg["init"]["chain_len"])
        t = np.zeros((n // cl, cl), np.int32)
        t[:, cl // 2:] = 1
        types = t.reshape(-1)
    else:
        types = np.asarray(tcfg if tcfg is not None else np.zeros(n),
                           np.int32)
    system = make_system(n, device, types=types, bonds=bonds)

    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    vel = rng.normal(0, np.sqrt(kT), (n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0)

    # --- engine ----------------------------------------------------------
    eng_cfg = cfg["engine"]
    pair = eng_cfg.get("pair", {"kind": "lj", "r_cut": 2.5})
    cvs_cfg = cfg.get("cvs", [])
    mcfg = cfg["metadynamics"]
    mode = mcfg.get("mode", "standard")
    packed = eng_cfg["kind"] == "packed"
    # the energy CV reads state.potential_energy at every bias evaluation
    # and the barostat state.virial at every step: every force call must
    # compute them (with_energy)
    want_energy = (any(c["kind"] == "wte" for c in cvs_cfg)
                   or icfg.get("kind") == "npt_scr"
                   or bool(eng_cfg.get("with_energy", False)))
    n_walkers = int(mcfg.get("n_walkers", 1))
    if bool(icfg.get("box_bias", False)) and (
            n_walkers > 1 or mode == "flux_tempered"):
        raise ValueError(
            "integrator.box_bias (box-shape metadynamics) needs the "
            "two-arg box-coupled integrator factory, which only the "
            "single-replica standard/well_tempered sampler supports")
    if icfg.get("kind") == "npt_scr" and tilt is not None:
        raise ValueError(
            "integrator npt_scr: SCR cell rescaling takes an orthorhombic "
            "box (a per-axis rescale does not commute with the tilt)")
    if packed:
        r_cut = float(pair.get("r_cut", 2.0 ** (1 / 6)
                               if pair["kind"] == "wca" else 2.5))
        # engine.bonds {kind: fene|harmonic, k, r0}; engine.fene the legacy
        # spelling (kind fene)
        fene = eng_cfg.get("bonds", eng_cfg.get("fene"))
        eps_tab = pair.get("eps_table")
        sig_tab = pair.get("sigma_table")
        eps_i = np.ones(n, np.float32)
        sigma_i = np.ones(n, np.float32)
        eps_scale = sigma_scale = None
        if eps_tab is not None:
            eps_scale, sigma_scale, ed, sd = pair_scale_tables(eps_tab,
                                                               sig_tab)
            eps_i = ed[types]
            if sd is not None:
                sigma_i = sd[types]
        elif sig_tab is not None:
            raise ValueError("sigma_table requires eps_table")
        spec = PackedSpec.create(
            L, n, r_cut=r_cut,
            skin=float(eng_cfg.get("skin", 0.4)),
            cap=eng_cfg.get("cap"),
            shift_energy=bool(pair.get("shift", pair["kind"] == "wca")),
            fene_k=None if fene is None else float(fene["k"]),
            fene_r0=None if fene is None else float(fene["r0"]),
            bond_kind=(fene or {}).get("kind", "fene"),
            uniform_sigma=eng_cfg.get("uniform_sigma"),
            uniform_eps=eng_cfg.get("uniform_eps"),
            pair_kind="soft" if pair["kind"] == "soft" else "lj",
            eps_scale=eps_scale, sigma_scale=sigma_scale, tilt=tilt)
        sp_raw = eng_cfg.get("spatial_devices", 1) or 1
        sp_2d = isinstance(sp_raw, (list, tuple))
        sp_dev = 1 if sp_2d else int(sp_raw)
        shards = blocks = None
        nbr_table = eng_cfg.get("nbr_table")
        if nbr_table is not None and (sp_2d or sp_dev > 1):
            raise ValueError("engine.nbr_table: the slot neighbour table is "
                             "the single-grid engine's (no spatial_devices)")
        if sp_2d:
            from .parallel.spatial2d import SpatialPackedEngine2D
            shape = (int(sp_raw[0]), int(sp_raw[1]))
            bad = {c["kind"] for c in cvs_cfg} - {
                "lamellar", "msd", "steinhardt", "q6", "coordination",
                "wte", "mesh"}
            if bad:
                raise ValueError(
                    f"cv kinds {sorted(bad)} are not supported under the "
                    "2-D decomposition yet")
            pair_k, order_k = (eng_cfg.get("pair_pallas"),
                               eng_cfg.get("order_pallas"))
            devs = _spatial_devices(shape[0] * shape[1], device)
            blocks = (devs, shape)
            # with walkers: walkers x 2-D space, all W walkers on every
            # shard (the reference's ``mpirun -n W*nx*ny --nrank W``)
            engine = SpatialPackedEngine2D(
                spec, devs, shape, nested=n_walkers > 1,
                rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                with_energy=(want_energy
                             or (pair_k is not None and not pair_k)),
                order_pallas=order_k is None or bool(order_k))
        elif sp_dev > 1:
            from .parallel.spatial import SpatialPackedEngine
            # the schema's pair_pallas: false is the reference's XLA pair
            # island, which computes the energy and virial on every force
            # call: with_energy here
            pair_k, order_k = (eng_cfg.get("pair_pallas"),
                               eng_cfg.get("order_pallas"))
            shards = _spatial_devices(sp_dev, device)
            # with walkers: the walkers x space product (the reference's
            # ``mpirun -n W*S --nrank W``), all W walkers on every shard
            nested = n_walkers > 1
            kinds = {c["kind"] for c in cvs_cfg}
            if nested and "aspect_ratio" in kinds:
                raise ValueError(
                    "the aspect-ratio (box-shape) CV needs the two-arg "
                    "box-coupled integrator factory, which multi-walker "
                    "runs do not take: not on a walkers x space product "
                    "(run it under plain spatial_devices)")
            if nested and "mesh" in kinds and kinds & {
                    "steinhardt", "q6", "coordination"}:
                raise ValueError(
                    "the mesh CV cannot be combined with steinhardt/"
                    "coordination CVs on a walkers x space product, as in "
                    "the reference: use mesh-only or order-CV-only runs")
            engine = SpatialPackedEngine(
                spec, shards, nested=nested,
                rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                with_energy=(want_energy
                             or (pair_k is not None and not pair_k)),
                order_pallas=order_k is None or bool(order_k))
        else:
            engine = PackedEngine(
                spec, device,
                rebuild_every=int(eng_cfg.get("rebuild_every", 1)),
                with_energy=want_energy,
                nbr_table=None if nbr_table is None else tuple(nbr_table))
        cvs, extra_attrs = _build_packed_cvs(cvs_cfg, spec, n, types,
                                             system.n_types, device, pos,
                                             shards=shards, box_L=L,
                                             blocks=blocks)
        if fene is not None:
            if bonds is None:
                raise ValueError("engine bonds (fene/bonds) need init "
                                 "kind melt")
            extra_attrs.update(bond_partner_attrs(bonds, n))
        state, ovf = engine.pack_state(pos, box, types, eps_i=eps_i,
                                       sigma_i=sigma_i, vel=vel,
                                       extra_attrs=extra_attrs)
        if ovf:
            raise RuntimeError("cell capacity overflow at pack: raise "
                               "engine.cap")
    else:
        tables = {"lj": lj_tables, "wca": wca_tables, "soft": soft_tables}
        kern = {"lj": lj_kernel, "wca": lj_kernel,
                "soft": soft_kernel}[pair["kind"]]
        params = tables[pair["kind"]](
            system.n_types, device=device,
            **{k: v for k, v in pair.items() if k != "kind"})
        engine = AllPairsEngine(system, pair_params=params, pair_kernel=kern,
                                row_block=int(eng_cfg.get("row_block", 1024)),
                                device=device)
        state = make_state(pos, box, vel=vel, device=device)
        cvs = _build_particle_cvs(cvs_cfg, system, L, device, pos)
    _check_wte(cvs, cvs_cfg)
    integ = _integrator_factory(icfg, system, packed,
                                spec=spec if packed else None,
                                engine=engine if packed else None)

    def stacked_walker_states():
        """The walker batch: every walker from the same positions, with
        fresh velocities from seed 1000 + w (the reference CLI's), all on
        ``device``."""
        def re_vel(w):
            v = np.random.default_rng(1000 + w).normal(
                0, np.sqrt(kT), (n, 3)).astype(np.float32)
            return v - v.mean(axis=0)

        if not packed:
            return stack_walkers([make_state(pos, box, vel=re_vel(w),
                                             device=device)
                                  for w in range(n_walkers)])
        states = []
        for w in range(n_walkers):
            st, ovf = engine.pack_state(pos, box, types, eps_i=eps_i,
                                        sigma_i=sigma_i, vel=re_vel(w),
                                        extra_attrs=extra_attrs)
            if ovf:
                raise RuntimeError("cell capacity overflow at pack: raise "
                                   "engine.cap")
            states.append(st)
        return stack_walkers(states)

    # --- metadynamics ----------------------------------------------------
    grid = _grid_from_cfg(cvs_cfg, device)
    if grid is not None:
        _check_start_in_grid(cvs, cvs_cfg, grid, state, system)
    # restart_from_grid: seed the bias from a grid dump and keep depositing
    # (unlike --resume, the MD state starts fresh)
    initial_bias = None
    if "restart_from_grid" in mcfg:
        if grid is None:
            raise ValueError("restart_from_grid needs grid-mode CVs")
        initial_bias, _ = load_grid(mcfg["restart_from_grid"], device)
        lspec = initial_bias.grid.spec
        if tuple(lspec.shape) != tuple(grid.shape):
            raise ValueError(f"grid dump shape {tuple(lspec.shape)} != "
                             f"config grid {tuple(grid.shape)}")
        if not (np.allclose(lspec.lo.cpu(), grid.lo.cpu())
                and np.allclose(lspec.hi.cpu(), grid.hi.cpu())):
            raise ValueError("grid dump CV ranges differ from the config's "
                             "grid ranges")
    walls = None
    if "wall_k" in mcfg and grid is not None:
        walls = WallSpec.at_grid_edges(grid, k=float(mcfg["wall_k"]))
    elif "wall_k" in mcfg:
        # hill-list mode: the walls from each CV's wall: {min, max}
        if not all("wall" in c for c in cvs_cfg):
            raise ValueError("wall_k without a grid needs wall: {min, max} "
                             "on every cv")
        import torch

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=device)

        walls = WallSpec(k=t([float(mcfg["wall_k"])] * len(cvs_cfg)),
                         lo=t([float(c["wall"]["min"]) for c in cvs_cfg]),
                         hi=t([float(c["wall"]["max"]) for c in cvs_cfg]))
    # resuming appends to the hill history instead of truncating it
    hill_overwrite = bool(out_cfg.get("overwrite", True)) and not resume
    # add_hills: false = a frozen-bias production run
    add_hills = bool(mcfg.get("add_hills", True))
    bias_every = int(mcfg.get("bias_every", 1))

    if mode == "flux_tempered":
        if grid is None:
            raise ValueError("flux-tempered mode needs a CV grid")
        if not add_hills:
            raise ValueError(
                "add_hills: false is a hill-deposition concept; flux-"
                "tempered mode rebuilds its bias from histograms instead")
        # with walkers: W replicas under the shared bias, the histograms
        # pooled at every update
        sampler = FluxTemperedSampler(
            system, stacked_walker_states() if n_walkers > 1 else state,
            engine, cvs=cvs, grid_spec=grid,
            initial_bias=initial_bias, integrator_factory=integ, kT=kT,
            stride=int(mcfg["stride"]),
            update_period=int(mcfg.get("update_period", 20)),
            seed=int(cfg.get("seed", 0)), walls=walls,
            update_rule=mcfg.get("update_rule", "flux"),
            gain0=float(mcfg.get("gain0", 0.5)),
            gain_halflife=int(mcfg.get("gain_halflife", 20)),
            bias_every=bias_every,
            min_round_trips=int(mcfg.get("min_round_trips", 1)),
            max_defer_periods=int(mcfg.get("max_defer_periods", 4)))
        return sampler, cfg

    hills = HillSpec.create(W=float(mcfg["W"]), stride=int(mcfg["stride"]),
                            mode=mode, deltaT=float(mcfg.get("deltaT", 1.0)))
    if n_walkers > 1:
        if grid is None:
            raise ValueError("multi-walker mode needs a CV grid")
        if bool(mcfg.get("mts_lag", False)):
            print("note: metadynamics.mts_lag applies to single-replica "
                  "runs; multi-walker mode uses plain bias_every MTS",
                  file=sys.stderr)
        sampler = WalkerSampler(
            system, stacked_walker_states(), engine, cvs=cvs,
            grid_spec=grid, hills=hills, integrator_factory=integ,
            seed=int(cfg.get("seed", 0)), initial_bias=initial_bias,
            walls=walls, hill_file=out_cfg.get("hill_file"),
            overwrite=hill_overwrite,
            chunks_per_block=int(cfg.get("chunks_per_block", 16)),
            add_hills=add_hills, bias_every=bias_every)
        return sampler, cfg
    sampler = MetadSampler(
        system, state, engine, cvs=cvs, grid_spec=grid, hills=hills,
        initial_bias=initial_bias, integrator_factory=integ,
        seed=int(cfg.get("seed", 0)), hill_file=out_cfg.get("hill_file"),
        overwrite=hill_overwrite, walls=walls,
        hill_sigma=([float(c.get("sigma", mcfg.get("sigma", 0.1)))
                     for c in cvs_cfg] if grid is None else None),
        hill_capacity=int(mcfg.get("hill_capacity", 4096)),
        chunks_per_block=int(cfg.get("chunks_per_block", 16)),
        add_hills=add_hills, bias_every=bias_every,
        mts_lag=_want_lag(mcfg, engine, cvs))
    return sampler, cfg


def _want_lag(mcfg: dict, engine, cvs) -> bool:
    """``metadynamics.mts_lag``, where it applies; otherwise a note on
    stderr and plain ``bias_every`` multiple time stepping."""
    from .sampler import lag_supported
    if not bool(mcfg.get("mts_lag", False)):
        return False
    if int(mcfg.get("bias_every", 1)) <= 1:
        print("note: metadynamics.mts_lag needs bias_every > 1; "
              "ignoring", file=sys.stderr)
        return False
    if lag_supported(engine, cvs):
        return True
    print("note: metadynamics.mts_lag requested but unsupported for this "
          "engine/CV combination (needs the sentinel-layout packed engine "
          "+ order CVs); falling back to plain bias_every MTS",
          file=sys.stderr)
    return False


class CliRun:
    """One ``run``: the sampler and its outputs.  :meth:`advance` runs one
    report interval and writes what the config asks for; the metrics come
    to the host once per block of strides, and the outputs read only
    those host copies (a grid dump or a checkpoint reads the device at its
    own interval)."""

    def __init__(self, cfg: dict, resume: bool = False, device="cuda"):
        from .io.metrics import CSVLogger

        out = self.out = cfg.get("output", {})
        self.ckpt_path = out.get("checkpoint")
        if resume and not (self.ckpt_path
                           and os.path.exists(self.ckpt_path)):
            raise FileNotFoundError("--resume needs output.checkpoint "
                                    "pointing at an existing file")
        self.sampler, cfg = build_sampler(cfg, resume=resume, device=device)
        self.cfg = cfg
        self.logger = (CSVLogger(out["log_file"], overwrite=not resume)
                       if "log_file" in out else None)
        self.ckpt_every = int(out.get("checkpoint_every", 0))
        self.grid_every = int(out.get("grid_every", 0))
        self.traj = None
        if "trajectory" in out:
            # the reference appends frames only for one replica's particle-
            # order positions, which packed states and walkers lack
            if hasattr(getattr(self.sampler, "state", None), "pos") and \
                    getattr(self.sampler, "n_walkers", None) is None:
                from .io.trajectory import make_trajectory_writer
                self.traj = make_trajectory_writer(out["trajectory"],
                                                   overwrite=not resume)
            else:
                print("note: output.trajectory: packed and multi-walker "
                      "runs write no frames", file=sys.stderr)
        self.n_steps = int(cfg["run"]["n_steps"])
        self.report = int(cfg["run"].get("report_every", self.n_steps))
        if resume:
            self.sampler.load_checkpoint(self.ckpt_path)
            print(f"resumed from {self.ckpt_path}", flush=True)
        self.done = 0
        self.warned_oog = False

    def save_ckpt(self) -> None:
        if self.ckpt_path:
            self.sampler.save_checkpoint(self.ckpt_path)

    def dump_bias_grid(self, step=None) -> None:
        from .io.grid_file import dump_grid
        # hill-list mode has no grid to dump
        if "grid_file" not in self.out or not hasattr(self.sampler.bias,
                                                      "grid"):
            return
        path = self.out["grid_file"]
        if step is not None and "{step}" in path:
            path = path.format(step=step)
        hills = getattr(self.sampler, "hills", None)
        dump_grid(path, self.sampler.bias,
                  mode=hills.mode if hills is not None else "flux_tempered",
                  deltaT=float(hills.deltaT) if hills is not None else 1.0)
        print(f"grid written to {path}", flush=True)

    def advance(self, todo: int) -> None:
        """Run ``todo`` steps and write their outputs; raise on a cell
        overflow or a cell-width violation (the forces were wrong)."""
        hist = self.sampler.run(todo)
        self.done += todo
        done = self.done
        if self.logger:
            self.logger.append(hist)
        m = hist[-1]
        cv = np.asarray(m["cv"]).round(4)
        temp = np.asarray(m["temperature"])
        print(f"step {done}: T={np.mean(temp):.3f} cv={cv.tolist()}",
              flush=True)
        if bool(np.any(np.asarray(m.get("nlist_overflow", False)))):
            self.save_ckpt()
            raise RuntimeError(
                f"cell-list overflow by step {done}: forces are invalid. "
                f"Raise engine.cap (or check for a blowup — e.g. a CV "
                f"grid/wall misconfiguration; see the log file).")
        if bool(np.any(np.asarray(m.get("cell_width_violation", False)))):
            self.save_ckpt()
            raise RuntimeError(
                f"cell width fell below r_cut+skin by step {done}: the "
                f"27-cell stencil no longer covers r_list and pairs are "
                f"being missed.")
        if not self.warned_oog and bool(
                np.any(np.asarray(m.get("cv_out_of_grid", False)))):
            self.warned_oog = True
            print(f"warning: a CV left its bias grid by step {done}; "
                  f"deposits clamp to the edge node (widen grid.min/max "
                  f"if this persists)", file=sys.stderr, flush=True)
        if self.traj is not None:
            # the leg's own count, as the reference writes it: a --resume
            # leg's frames count from 0 again
            st = self.sampler.state
            self.traj.append(st.pos.cpu().numpy(), st.image.cpu().numpy(),
                             st.box.L.cpu().numpy(), done)
        if self.ckpt_every and done % self.ckpt_every == 0:
            self.save_ckpt()
        if self.grid_every and done % self.grid_every == 0 \
                and done < self.n_steps:
            self.dump_bias_grid(step=done)

    def run(self) -> None:
        """``n_steps`` in report intervals, then the final checkpoint and
        grid dump."""
        while self.done < self.n_steps:
            self.advance(min(self.report, self.n_steps - self.done))
        self.save_ckpt()
        self.dump_bias_grid(step=self.n_steps)
        if hasattr(self.traj, "close"):
            self.traj.close()


def resolve_device(device):
    """``device`` or, when None, ``cuda``; raise when CUDA is asked for and
    torch finds no CUDA device."""
    import torch
    device = device or "cuda"
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass --device cpu to run "
                           "on the CPU")
    return device


def run_config(cfg: dict, resume: bool = False, device=None) -> CliRun:
    """Build and run a config (``run``'s body).  Returns the finished run."""
    r = CliRun(cfg, resume=resume, device=resolve_device(device))
    r.run()
    return r


def cmd_run(args) -> int:
    from .io.config import load_config
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    run_config(load_config(args.config), resume=args.resume, device=device)
    return 0


def _write_fes(path: str, coords, F, err=None) -> None:
    """An FES table: one row per grid node, the CV coordinates then F (and
    the block-analysis error); ``.npz`` keeps the N-d arrays."""
    F = np.asarray(F)
    if path.endswith(".npz"):
        extra = {} if err is None else {"err": np.asarray(err)}
        np.savez(path, F=F, **{f"cv{i}": np.asarray(c)
                               for i, c in enumerate(coords)}, **extra)
        return
    mesh = np.meshgrid(*coords, indexing="ij")
    cols = [m.ravel() for m in mesh] + [F.ravel()]
    names = [f"cv{i}" for i in range(len(coords))] + ["free_energy"]
    if err is not None:
        cols.append(np.asarray(err).ravel())
        names.append("error")
    with open(path, "w") as f:
        f.write("#! FIELDS " + " ".join(names) + "\n")
        np.savetxt(f, np.stack(cols, axis=1), fmt="%.8g")


def cmd_sum_hills(args) -> int:
    """The FES from a hill log by direct summation (PLUMED ``sum_hills``)."""
    from .io.hill_log import fes_error_from_hills, fes_from_hills, read_hills

    h = read_hills(args.hills)
    if h["step"].size == 0:
        print("no hills in file", file=sys.stderr)
        return 1
    d = h["center"].shape[1]
    lo = (np.asarray([float(x) for x in args.min.split(",")])
          if args.min else h["center"].min(0) - 3.0 * h["sigma"].max(0))
    hi = (np.asarray([float(x) for x in args.max.split(",")])
          if args.max else h["center"].max(0) + 3.0 * h["sigma"].max(0))
    bins = [int(b) for b in args.bins.split(",")] if args.bins else [101] * d
    if not len(lo) == len(hi) == len(bins) == d:
        raise ValueError(f"hill file has {d} CVs; --min/--max/--bins must "
                         "match")
    coords = [np.linspace(lo[i], hi[i], bins[i]) for i in range(d)]
    err = None
    if args.blocks:
        F, err = fes_error_from_hills(
            args.hills, coords, n_blocks=args.blocks, mode=args.mode,
            kT=args.kT, deltaT=args.deltaT)
        print(f"block analysis ({args.blocks} blocks): "
              f"mean err {err.mean():.4g}, max {err.max():.4g}")
    else:
        F = fes_from_hills(args.hills, coords, mode=args.mode, kT=args.kT,
                           deltaT=args.deltaT)
    _write_fes(args.out, coords, F, err=err)
    print(f"FES ({'x'.join(str(b) for b in bins)}, "
          f"range {F.max() - F.min():.4g}) written to {args.out}")
    return 0


def cmd_fes(args) -> int:
    """The FES of a grid dump: F = −V (standard, flux-tempered) or
    −(kT + ΔT)/ΔT·V (well-tempered), shifted to min 0."""
    from .io.grid_file import load_grid

    bias, meta = load_grid(args.grid)
    V = bias.grid.V.numpy()
    mode, deltaT = meta["mode"], meta["deltaT"]
    if args.mode:
        mode = args.mode
    F = -V if mode in ("standard", "flux_tempered") \
        else -(args.kT + deltaT) / deltaT * V
    F = F - F.min()
    spec = bias.grid.spec
    coords = [np.linspace(float(spec.lo[i]), float(spec.hi[i]),
                          spec.shape[i]) for i in range(len(spec.shape))]
    _write_fes(args.out, coords, F)
    print(f"FES (mode={mode}, range {F.max():.4g}) written to {args.out}")
    return 0


def cmd_rdf(args) -> int:
    """g(r) of a dumped trajectory (``.gsd``, ``.dcd`` or npz frames)."""
    from .io.trajectory import read_dcd, read_trajectory
    from .utils.analysis import rdf

    if args.traj.endswith(".gsd"):
        from .io.gsd_file import read_gsd_frames

        def read(path):
            frames = read_gsd_frames(path)
            return {
                "pos": np.stack([f["particles/position"] for f in frames]),
                "box_L": np.stack([f["configuration/box"][:3]
                                   for f in frames]),
            }
    else:
        read = read_dcd if args.traj.endswith(".dcd") else read_trajectory
    d = read(args.traj)
    pos, box_L = d["pos"][args.skip:], np.asarray(d["box_L"])
    if box_L.ndim == 2:
        box_L = box_L[args.skip:]
    if pos.shape[0] == 0:
        raise ValueError("no frames left after --skip")
    r, g = rdf(pos, box_L, r_max=args.r_max, n_bins=args.bins)
    if args.out.endswith(".npz"):
        np.savez(args.out, r=r, g=g)
    else:
        np.savetxt(args.out, np.column_stack([r, g]), header="r g(r)")
    print(f"rdf over {pos.shape[0]} frames -> {args.out}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="metadyn-torch",
        description="metadynamics MD, the PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="run a simulation from a YAML config")
    runp.add_argument("config")
    runp.add_argument("--resume", action="store_true",
                      help="resume from output.checkpoint")
    runp.add_argument("--device", default=None,
                      help="torch device (default cuda; cpu to run on the "
                           "CPU)")
    shp = sub.add_parser(
        "sum-hills",
        help="reconstruct the FES from a hill log (PLUMED sum_hills)")
    shp.add_argument("hills", help="hill log file (HILLS)")
    shp.add_argument("--out", default="fes.dat",
                     help="output table (.dat columns or .npz)")
    shp.add_argument("--min", help="comma-separated grid minima per CV")
    shp.add_argument("--max", help="comma-separated grid maxima per CV")
    shp.add_argument("--bins", help="comma-separated bin counts per CV")
    shp.add_argument("--mode", default="standard",
                     choices=["standard", "well_tempered"])
    shp.add_argument("--kT", type=float, default=1.0)
    shp.add_argument("--deltaT", type=float, default=1.0)
    shp.add_argument("--blocks", type=int, default=0,
                     help="time-block convergence analysis: snapshot the "
                          "cumulative FES N times, report the aligned "
                          "across-block std-dev as an extra column")
    fesp = sub.add_parser(
        "fes", help="FES from a bias-grid dump (output.grid_file)")
    fesp.add_argument("grid", help="grid dump (.npz from dump_grid)")
    fesp.add_argument("--out", default="fes.dat")
    fesp.add_argument("--mode", help="override the mode stored in the dump")
    fesp.add_argument("--kT", type=float, default=1.0)
    rdfp = sub.add_parser(
        "rdf", help="radial distribution function g(r) of a trajectory")
    rdfp.add_argument("traj", help="trajectory (.gsd, .dcd or .npz)")
    rdfp.add_argument("--out", default="rdf.dat",
                      help="output table: r, g(r)")
    rdfp.add_argument("--bins", type=int, default=100)
    rdfp.add_argument("--r-max", type=float, default=None,
                      help="default: min(L)/2")
    rdfp.add_argument("--skip", type=int, default=0,
                      help="drop the first N frames (equilibration)")
    args = p.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "sum-hills":
        return cmd_sum_hills(args)
    if args.cmd == "fes":
        return cmd_fes(args)
    return cmd_rdf(args)


if __name__ == "__main__":
    sys.exit(main())

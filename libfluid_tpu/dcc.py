"""DCC integration: the Maya plugin's node graph as a host-side Python API.

The reference ships an Autodesk Maya plugin (L6, ``plugins/maya/``) whose role
is *content-pipeline integration*: dependency-graph nodes that lazily recompute
simulation frames with caching, mesh the particles, voxelize obstacle meshes,
and load exported point clouds (``grid_node.cpp``, ``mesher_node.cpp``,
``voxelizer_node.cpp``, ``point_cloud_loader_node.cpp``), plus commands that
wire them together (``create_simulation_grid.cpp:23-96``). This framework has
no Maya process; the equivalent capability is this module — the same node
semantics (pull-based evaluation, per-frame particle caching, attribute-change
invalidation ``grid_node.cpp:377-383``) exposed as plain Python objects any DCC
bridge or notebook can drive.

Nodes form a DAG: setting an attribute dirties the node and everything
downstream; ``evaluate()`` pulls clean values through the chain. ``GridNode``
keeps the full end-of-frame :class:`SimState` of the *last computed frame*
(the reference keeps ``_last_frame_particles``, ``grid_node.cpp:351,366``) so
advancing time is incremental, while per-frame particle snapshots accumulate
in a host-side cache for scrubbing backwards.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax

from libfluid_tpu.config import MesherConfig, SimConfig, TransferScheme
from libfluid_tpu.mesher.marching_cubes import MeshBuffers, generate_mesh
from libfluid_tpu.sim import SimState, new_state, step as sim_step
from libfluid_tpu.sim.sources import make_source_set
from libfluid_tpu.sim.state import set_solid
from libfluid_tpu import voxelizer as vox_mod
from libfluid_tpu.io.point_cloud import load_points


class Node:
    """Minimal pull-based dependency-graph node (stand-in for MPxNode)."""

    def __init__(self, **attrs):
        self._attrs: Dict[str, object] = {}
        self._downstream: List["Node"] = []
        self._dirty = True
        for k, v in attrs.items():
            self._attrs[k] = v

    def connect(self, downstream: "Node") -> "Node":
        self._downstream.append(downstream)
        downstream.invalidate()
        return downstream

    def set(self, **attrs) -> "Node":
        """Set attributes; any change invalidates this node and downstream
        (``grid_node::setDependentsDirty``, ``grid_node.cpp:377-383``)."""
        changed = False
        for k, v in attrs.items():
            if k not in self._attrs:
                raise AttributeError(f"{type(self).__name__} has no attribute {k!r}")
            old = self._attrs[k]
            if not (np.isscalar(old) and np.isscalar(v) and old == v):
                changed = True
            self._attrs[k] = v
        if changed:
            self.invalidate()
        return self

    def get(self, name: str):
        return self._attrs[name]

    def invalidate(self):
        self._dirty = True
        self._on_invalidate()
        for n in self._downstream:
            n.invalidate()

    def _on_invalidate(self):
        pass

    def evaluate(self):
        if self._dirty:
            self._compute()
            self._dirty = False
        return self._output()

    def _compute(self):
        raise NotImplementedError

    def _output(self):
        raise NotImplementedError


class GridNode(Node):
    """The simulation node (``grid_node.cpp``): attributes mirror the Maya
    attribute set (time, cellSize, gridSize, gridOffset, gravity,
    transferMethod, sources, obstacles — ``grid_node.cpp:48-226``); evaluation
    re-runs the simulation up to the requested frame, caching per-frame
    particle positions (``grid_node.cpp:228-375``)."""

    def __init__(
        self,
        grid_size=(50, 50, 50),
        cell_size=1.0,
        grid_offset=(0.0, 0.0, 0.0),
        gravity=(0.0, -981.0, 0.0),
        method: TransferScheme = TransferScheme.APIC,
        frames_per_second: float = 24.0,
        particle_capacity: int = 1 << 17,
        seed: int = 0,
    ):
        super().__init__(
            time=0,
            grid_size=tuple(grid_size),
            cell_size=float(cell_size),
            grid_offset=tuple(grid_offset),
            gravity=tuple(gravity),
            method=method,
            frames_per_second=float(frames_per_second),
            particle_capacity=int(particle_capacity),
            seed=int(seed),
            sources=(),      # tuple of dicts: cells/velocity/coerce/density
            obstacles=(),    # tuple of (positions, indices) meshes
        )
        self._seeders = []  # host-side initial-state seeding closures
        self._cache: List[np.ndarray] = []  # per-frame particle snapshots
        self._last_state: Optional[SimState] = None
        self._step_fn = None

    # -- initial conditions (the reference seeds via MEL/attribute edits) --

    def add_seeder(self, fn) -> "GridNode":
        """fn(state, cfg) -> state, applied at frame 0 (seed_box/seed_sphere
        partials). Mutating the seed set invalidates the cache."""
        self._seeders.append(fn)
        self.invalidate()
        return self

    def _on_invalidate(self):
        # Any non-time attribute change clears the frame cache; the `time`
        # attribute goes through set_time() which does NOT invalidate.
        self._cache.clear()
        self._last_state = None
        self._step_fn = None

    def set_time(self, frame: int) -> "GridNode":
        """Scrub the time attribute without clearing the cache (time changes
        are exempt in ``setDependentsDirty``, ``grid_node.cpp:378``)."""
        self._attrs["time"] = int(frame)
        self._dirty = True
        for n in self._downstream:
            n.invalidate()
        return self

    def _config(self) -> SimConfig:
        return SimConfig(
            grid_size=self.get("grid_size"),
            cell_size=self.get("cell_size"),
            grid_offset=self.get("grid_offset"),
            gravity=self.get("gravity"),
            scheme=self.get("method"),
            particle_capacity=self.get("particle_capacity"),
        )

    def _initial_state(self, cfg: SimConfig) -> SimState:
        state = new_state(cfg, jax.random.PRNGKey(self.get("seed")))
        for fn in self._seeders:
            state = fn(state, cfg)
        srcs = self.get("sources")
        if srcs:
            cells = np.concatenate([np.asarray(s["cells"]).reshape(-1, 3) for s in srcs])
            vel = np.concatenate(
                [
                    np.broadcast_to(
                        np.asarray(s["velocity"], np.float32),
                        (np.asarray(s["cells"]).reshape(-1, 3).shape[0], 3),
                    )
                    for s in srcs
                ]
            )
            coerce = np.concatenate(
                [
                    np.full(np.asarray(s["cells"]).reshape(-1, 3).shape[0],
                            bool(s.get("coerce_velocity", False)))
                    for s in srcs
                ]
            )
            dens = np.concatenate(
                [
                    np.full(np.asarray(s["cells"]).reshape(-1, 3).shape[0],
                            int(s.get("density", cfg.seeding_density)), np.int32)
                    for s in srcs
                ]
            )
            state = state._replace(
                sources=make_source_set(cells, vel, True, coerce, dens)
            )
        solid = None
        for positions, indices in self.get("obstacles"):
            cells = vox_mod.obstacle_cells(positions, indices, cfg)
            mask = np.zeros(cfg.grid_size, bool)
            c = np.asarray(cells)
            if c.size:
                mask[c[:, 0], c[:, 1], c[:, 2]] = True
            solid = mask if solid is None else (solid | mask)
        if solid is not None:
            state = set_solid(state, solid)
        return state

    def _compute(self):
        frame = int(self.get("time"))
        cfg = self._config()
        if self._last_state is None:
            self._last_state = self._initial_state(cfg)
            self._cache = [self._snapshot(self._last_state)]
            self._step_fn = jax.jit(
                lambda s: sim_step(s, cfg, 1.0 / self.get("frames_per_second"))
            )
        while frame >= len(self._cache):
            self._last_state, _ = self._step_fn(self._last_state)
            self._cache.append(self._snapshot(self._last_state))

    @staticmethod
    def _snapshot(state: SimState) -> np.ndarray:
        pos = np.asarray(state.position)
        act = np.asarray(state.active)
        return pos[act]

    def _output(self) -> np.ndarray:
        """(n, 3) active particle positions at the current frame."""
        return self._cache[min(int(self.get("time")), len(self._cache) - 1)]

    @property
    def state(self) -> Optional[SimState]:
        """Full SimState at the newest computed frame (for checkpointing)."""
        return self._last_state


class MesherNode(Node):
    """particles -> triangle mesh (``mesher_node.cpp:96-182``)."""

    def __init__(
        self,
        source: Node,
        cfg: Optional[MesherConfig] = None,
        particle_radius: Optional[float] = None,
    ):
        super().__init__(cfg=cfg or MesherConfig(), particle_radius=particle_radius)
        self._source = source
        source.connect(self)
        self._mesh: Optional[MeshBuffers] = None
        self._fn = None

    def _compute(self):
        cfg: MesherConfig = self.get("cfg")
        positions = np.asarray(self._source.evaluate())
        n = positions.shape[0]
        cap = max(1 << int(np.ceil(np.log2(max(n, 1)))), 1024)
        pos = np.zeros((cap, 3), np.float32)
        pos[:n] = positions
        active = np.zeros((cap,), bool)
        active[:n] = True
        if self._fn is None:
            r = self.get("particle_radius")
            self._fn = jax.jit(
                lambda p, a: generate_mesh(p, a, cfg, r), static_argnums=()
            )
        self._mesh = jax.block_until_ready(self._fn(pos, active))

    def _output(self) -> Tuple[np.ndarray, int]:
        """(vertices (T,3,3), count) triangle soup."""
        return np.asarray(self._mesh.vertices), int(self._mesh.count)


class VoxelizerNode(Node):
    """obstacle mesh -> occupied sim-grid cells (``voxelizer_node.cpp:193-347``)."""

    def __init__(self, positions, indices, sim_cfg: SimConfig):
        super().__init__(
            positions=np.asarray(positions, np.float64),
            indices=np.asarray(indices, np.int64),
            sim_cfg=sim_cfg,
        )
        self._cells: Optional[np.ndarray] = None

    def _compute(self):
        self._cells = np.asarray(
            vox_mod.obstacle_cells(
                self.get("positions"), self.get("indices"), self.get("sim_cfg")
            )
        )

    def _output(self) -> np.ndarray:
        """(k, 3) int cell indices occupied by the obstacle interior+surface."""
        return self._cells


class PointCloudLoaderNode(Node):
    """points.txt -> particle positions (``point_cloud_loader_node.cpp:48-80``)."""

    def __init__(self, path: str):
        super().__init__(path=path)
        self._points: Optional[np.ndarray] = None

    def _compute(self):
        self._points = np.asarray(load_points(self.get("path")))

    def _output(self) -> np.ndarray:
        return self._points


class GridManipulatorNode(Node):
    """Viewport-overlay geometry for a :class:`GridNode` — the headless
    equivalent of the Maya viewport manipulator
    (``grid_manipulator_node.cpp:27-78``), which draws the grid's bounding
    box and the cached frame's particles. Returns plain arrays any viewer
    (matplotlib, a notebook, a DCC bridge) can draw:

    ``evaluate()`` -> dict with
      - ``box_segments``: (12, 2, 3) world-space line segments of the domain
      - ``particles``: (N, 3) positions of the current frame's particles
    """

    def __init__(self, grid: "GridNode"):
        super().__init__()
        self.grid = grid
        grid.connect(self)  # time/attribute changes re-dirty the overlay
        self._overlay = None

    def _compute(self):
        positions = self.grid.evaluate()
        cfg = self.grid._config()
        lo = np.asarray(cfg.domain_min, np.float64)
        hi = np.asarray(cfg.domain_max, np.float64)
        corners = np.array(
            [
                [x, y, z]
                for x in (lo[0], hi[0])
                for y in (lo[1], hi[1])
                for z in (lo[2], hi[2])
            ]
        )  # (8, 3), index bits = (x, y, z)
        edges = [
            (0, 1), (2, 3), (4, 5), (6, 7),  # z edges
            (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
            (0, 4), (1, 5), (2, 6), (3, 7),  # x edges
        ]
        segs = np.stack([corners[list(e)] for e in edges])  # (12, 2, 3)
        self._overlay = {
            "box_segments": segs,
            "particles": np.asarray(positions),
        }

    def _output(self):
        return self._overlay


def create_simulation_pipeline(
    grid_kwargs: Optional[dict] = None,
    mesher_cfg: Optional[MesherConfig] = None,
) -> Tuple[GridNode, MesherNode]:
    """Wire time -> grid -> mesher, like the ``libfluidCreateSimulationGrid``
    command's DG network (``create_simulation_grid.cpp:23-96``)."""
    grid = GridNode(**(grid_kwargs or {}))
    mesher = MesherNode(grid, mesher_cfg)
    return grid, mesher

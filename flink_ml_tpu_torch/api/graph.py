"""Graph / GraphBuilder / GraphModel — DAG composition of stages.

The reference snapshot ships only the linear ``Pipeline`` (SURVEY §2.1), but
the Flink ML 2.x API line pairs it with a Graph API for non-linear wiring:
stages consume and produce named tables, estimators are fitted on their
resolved inputs and replaced by their models, and the whole DAG is itself an
``Estimator`` whose fit yields a ``GraphModel``.

Composition is pure host-side wiring: each node's ``fit``/``transform``
runs its own device work; the graph adds none of its own.  Acyclicity is
by construction: a node's inputs must be ``TableId``s that already exist
when the node is added, so insertion order IS a topological order.

A copy of the JAX package's ``api/graph.py``.

Example::

    builder = GraphBuilder()
    raw = builder.source()
    scaled = builder.add_stage(StandardScaler(), [raw])[0]
    pred = builder.add_stage(KMeans(), [scaled])[0]
    graph = builder.build(inputs=[raw], outputs=[pred])   # an Estimator
    model = graph.fit(table)                              # a GraphModel
    (result,) = model.transform(table)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from ..utils import persist
from .stage import AlgoOperator, Estimator, Model, Stage

__all__ = ["TableId", "GraphBuilder", "Graph", "GraphModel"]


@dataclass(frozen=True)
class TableId:
    """Opaque handle for a table flowing through the graph."""

    id: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TableId({self.id})"


@dataclass
class _GraphNode:
    stage: Stage
    inputs: List[int]
    outputs: List[int]


class GraphBuilder:
    """Accumulates nodes; ``build`` freezes them into a ``Graph``."""

    def __init__(self):
        self._next_id = 0
        self._known: set = set()
        self._nodes: List[_GraphNode] = []

    def _new_id(self) -> TableId:
        tid = TableId(self._next_id)
        self._next_id += 1
        self._known.add(tid.id)
        return tid

    def source(self) -> TableId:
        """Declare an external input table (the analog of
        ``GraphBuilder.createTableId`` used for graph inputs)."""
        return self._new_id()

    def add_stage(self, stage: Stage, inputs: Sequence[TableId],
                  n_outputs: int = 1) -> List[TableId]:
        """Wire ``stage`` to consume ``inputs``; returns its ``n_outputs``
        fresh output ids.  Inputs must already exist (sources or earlier
        outputs), which keeps the graph acyclic by construction."""
        if not isinstance(stage, (Estimator, AlgoOperator)):
            raise TypeError(f"{type(stage).__name__} is neither an Estimator "
                            "nor an AlgoOperator")
        if n_outputs < 1:
            raise ValueError("n_outputs must be >= 1")
        in_ids = []
        for t in inputs:
            if not isinstance(t, TableId) or t.id not in self._known:
                raise ValueError(f"Unknown input table {t!r}; inputs must "
                                 "come from source() or earlier add_stage()")
            in_ids.append(t.id)
        outs = [self._new_id() for _ in range(n_outputs)]
        self._nodes.append(_GraphNode(stage, in_ids, [o.id for o in outs]))
        return outs

    def build(self, inputs: Sequence[TableId],
              outputs: Sequence[TableId]) -> "Graph":
        input_ids = [t.id for t in inputs]
        # every node input must be reachable: a declared graph input or an
        # earlier node's output (a forgotten source() must fail here, not as
        # a bare KeyError mid-fit)
        available = set(input_ids)
        for node in self._nodes:
            for i in node.inputs:
                if i not in available:
                    raise ValueError(
                        f"Node input TableId({i}) is neither a build() input "
                        "nor produced by an earlier node — did you forget to "
                        "list a source() in build(inputs=...)?")
            available.update(node.outputs)
        for t in outputs:
            if t.id not in available:
                raise ValueError(f"Output {t!r} is produced by no node")
        return Graph(self._nodes, input_ids, [t.id for t in outputs])


def _run_node(stage: AlgoOperator, node: _GraphNode,
              env: Dict[int, object]) -> None:
    """Transform the node's resolved inputs into its output slots — THE one
    place the arity check and slot assignment live (fit and transform both
    route through it)."""
    results = stage.transform(*[env[i] for i in node.inputs])
    if len(results) < len(node.outputs):
        raise ValueError(
            f"{type(stage).__name__} produced {len(results)} tables, "
            f"but the graph wires {len(node.outputs)}")
    for out_id, table in zip(node.outputs, results):
        env[out_id] = table


class _GraphBase:
    """Shared wiring + persistence for Graph and GraphModel."""

    def __init__(self, nodes: Sequence[_GraphNode] = (),
                 input_ids: Sequence[int] = (),
                 output_ids: Sequence[int] = ()):
        super().__init__()  # continue the MRO into Estimator/Model params
        self._nodes = list(nodes)
        self._input_ids = list(input_ids)
        self._output_ids = list(output_ids)

    def _bind_inputs(self, inputs) -> Dict[int, object]:
        if len(inputs) != len(self._input_ids):
            raise ValueError(f"Expected {len(self._input_ids)} input tables, "
                             f"got {len(inputs)}")
        return dict(zip(self._input_ids, inputs))

    def _wiring(self) -> dict:
        return {
            "inputIds": self._input_ids,
            "outputIds": self._output_ids,
            "nodes": [{"inputs": n.inputs, "outputs": n.outputs}
                      for n in self._nodes],
        }

    def save(self, path: str) -> None:
        persist.save_metadata(self, path, {"graph": self._wiring()})
        for i, node in enumerate(self._nodes):
            node.stage.save(persist.stage_path(path, i))

    @classmethod
    def load(cls, path: str):
        meta = persist.load_metadata(path, cls)
        wiring = meta["graph"]
        nodes = [
            _GraphNode(persist.load_stage(persist.stage_path(path, i)),
                       spec["inputs"], spec["outputs"])
            for i, spec in enumerate(wiring["nodes"])
        ]
        return cls(nodes, wiring["inputIds"], wiring["outputIds"])


class Graph(_GraphBase, Estimator["GraphModel"]):
    """The frozen DAG as an Estimator: fitting walks nodes in insertion
    (= topological) order, fitting estimators on their resolved inputs and
    transforming through every node to feed downstream consumers."""

    def fit(self, *inputs) -> "GraphModel":
        env = self._bind_inputs(inputs)
        fitted: List[AlgoOperator] = []
        for node in self._nodes:
            if isinstance(node.stage, AlgoOperator):
                stage: AlgoOperator = node.stage
            else:
                stage = node.stage.fit(*[env[i] for i in node.inputs])
            fitted.append(stage)
            _run_node(stage, node, env)
        model_nodes = [_GraphNode(s, n.inputs, n.outputs)
                       for s, n in zip(fitted, self._nodes)]
        return GraphModel(model_nodes, self._input_ids, self._output_ids)


class GraphModel(_GraphBase, Model):
    """The fitted DAG: transform re-walks the wiring with models only."""

    def transform(self, *inputs) -> List:
        env = self._bind_inputs(inputs)
        for node in self._nodes:
            _run_node(node.stage, node, env)
        return [env[i] for i in self._output_ids]

"""Small graph/queue helpers (the port's copy of the JAX package's
``utils/graph.py``, pure Python).

Reference: paxi lib/ — standalone data structures used by protocol
packages (a directed graph with SCC detection and BFS for EPaxos's
dependency execution, and a priority queue) [low-conf row of SURVEY
§2.1].  The EPaxos host replica carries a fused Tarjan specialised for
blocked-dependency tracking; these are the general-purpose forms.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Set

Node = Hashable


class Graph:
    """Directed graph over hashable nodes (paxi lib/graph.go analog)."""

    def __init__(self):
        self._adj: Dict[Node, Set[Node]] = {}

    def add_node(self, u: Node) -> None:
        self._adj.setdefault(u, set())

    def add_edge(self, u: Node, v: Node) -> None:
        self.add_node(u)
        self.add_node(v)
        self._adj[u].add(v)

    def remove(self, u: Node) -> None:
        self._adj.pop(u, None)
        for vs in self._adj.values():
            vs.discard(u)

    def nodes(self) -> List[Node]:
        return list(self._adj)

    def neighbors(self, u: Node) -> Set[Node]:
        return self._adj.get(u, set())

    def __contains__(self, u: Node) -> bool:
        return u in self._adj

    def __len__(self) -> int:
        return len(self._adj)

    # ---- traversal -----------------------------------------------------
    def bfs(self, src: Node) -> List[Node]:
        """Nodes reachable from src in BFS order (src first)."""
        seen = {src}
        order = [src]
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for v in sorted(self.neighbors(u), key=repr):
                    if v not in seen:
                        seen.add(v)
                        order.append(v)
                        nxt.append(v)
            frontier = nxt
        return order

    def scc(self) -> List[List[Node]]:
        """Strongly connected components, in reverse topological order
        (every component precedes the ones that depend on it) — the
        order EPaxos executes in.  Iterative Tarjan."""
        index: Dict[Node, int] = {}
        low: Dict[Node, int] = {}
        on_stack: Set[Node] = set()
        stack: List[Node] = []
        comps: List[List[Node]] = []
        counter = [0]

        def connect(root: Node) -> None:
            work = [(root, iter(sorted(self.neighbors(root), key=repr)))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                u, it = work[-1]
                advanced = False
                for v in it:
                    if v not in index:
                        index[v] = low[v] = counter[0]
                        counter[0] += 1
                        stack.append(v)
                        on_stack.add(v)
                        work.append((v, iter(sorted(self.neighbors(v),
                                                    key=repr))))
                        advanced = True
                        break
                    if v in on_stack:
                        low[u] = min(low[u], index[v])
                if advanced:
                    continue
                work.pop()
                if work:
                    p = work[-1][0]
                    low[p] = min(low[p], low[u])
                if low[u] == index[u]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == u:
                            break
                    comps.append(comp)

        for u in sorted(self._adj, key=repr):
            if u not in index:
                connect(u)
        return comps


class PriorityQueue:
    """Min-heap with stable insertion order on ties (paxi lib pq)."""

    def __init__(self):
        self._heap: list = []
        self._n = 0

    def push(self, priority, item) -> None:
        self._n += 1
        heapq.heappush(self._heap, (priority, self._n, item))

    def pop(self):
        if not self._heap:
            raise IndexError("pop from empty PriorityQueue")
        return heapq.heappop(self._heap)[2]

    def peek(self):
        if not self._heap:
            raise IndexError("peek on empty PriorityQueue")
        return self._heap[0][2]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

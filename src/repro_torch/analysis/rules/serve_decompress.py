"""serve-never-decompresses: the engine serves compressed-resident.

Port of the JAX rule.  The invariant: ``decompress_params`` exists only
as the correctness oracle the engine is *tested against* — if any call
path from ``serve/engine.py`` or ``serve/supervisor.py`` reaches it,
compressed serving silently degrades to dense residency (1.6× the weight
bytes of 2:4 bf16, and K2 never runs).  Runtime tests only catch this on
the exact path they exercise; the call-graph check covers every path.
"""
from __future__ import annotations

from repro_torch.analysis.engine import RepoIndex
from repro_torch.analysis.findings import Finding


class ServeNeverDecompressesRule:
    name = "serve-never-decompresses"
    severity = "error"
    description = ("no call path from serve/engine.py or "
                   "serve/supervisor.py reaches decompress_params")

    seed_modules = ("repro_torch.serve.engine",
                    "repro_torch.serve.supervisor")
    forbidden = "decompress_params"

    def check(self, index: RepoIndex) -> list[Finding]:
        graph = index.graph
        seeds = [
            key
            for mod in self.seed_modules
            for key in graph.by_module.get(mod, {}).values()
        ]
        chains = graph.reachable(seeds)
        findings: list[Finding] = []
        for key, chain in chains.items():
            info = graph.functions[key]
            if info.name != self.forbidden:
                continue
            origin = graph.functions[chain[0]]
            via = " -> ".join(graph.functions[k].qualname for k in chain)
            findings.append(Finding(
                path=origin.relpath, line=origin.lineno, rule=self.name,
                severity=self.severity, symbol=origin.qualname,
                message=f"serve path reaches {self.forbidden} "
                        f"(compressed residency lost): {via}"))
        return findings

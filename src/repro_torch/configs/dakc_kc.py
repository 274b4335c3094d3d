"""The paper's own workload: distributed k-mer counting configuration.

Not a transformer: this config drives the counter's drivers (k=31 as in
all the paper's experiments, Sec. VI). The port's copy of
`repro.configs.dakc_kc`, pure data.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class KCWorkloadConfig:
    k: int = 31
    read_len: int = 150          # paper Table V
    chunk_reads: int = 256
    slack: float = 1.5
    l3_mode: str = "auto"
    topology: str = "1d"
    canonical: bool = False


def config() -> KCWorkloadConfig:
    return KCWorkloadConfig()

"""core modules of the PyTorch port: the DAKC counter as composable
PyTorch modules (counterpart of `repro.core`)."""

from repro_torch.core import (aggregation, analytical_model, countstore,  # noqa: F401
                              encoding, owner, sort)
from repro_torch.core.bsp import BSPConfig, count_kmers as count_kmers_bsp  # noqa: F401
from repro_torch.core.countstore import CountStore  # noqa: F401
from repro_torch.core.fabsp import (DAKCConfig, DAKCStats, KmerCounter,  # noqa: F401
                                    count_kmers)
from repro_torch.core.serial import count_kmers_serial  # noqa: F401
from repro_torch.core.sort import AccumResult, accumulate  # noqa: F401

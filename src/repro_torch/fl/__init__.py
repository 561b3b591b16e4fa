"""Federated learning on F2P-quantized client updates (port of
``repro.fl``, DESIGN.md §7.4).

The paper's FL claim, made runnable: clients send their local model deltas
as :class:`repro_torch.core.qtensor.QTensor` trees (F2P8 codes + per-block
scales, ~3.9x fewer wire bytes than f32), the server aggregates directly on
codes+scales, and error feedback keeps convergence at parity with f32
fed-avg. On the card each client leaf's quantize is one launch of B5
(codes) or B3 (packed words), each dequantize one of B6 or B4.
"""
from repro_torch.fl.client import (ClientConfig, init_client_residuals,
                                   make_client_update)
from repro_torch.fl.exact import (AggregationOverflow, ExactAggregator,
                                  UpdateRejected, aggregate_exact,
                                  validate_update)
from repro_torch.fl.rounds import (AutotuneConfig, FedAvgConfig, FleetConfig,
                                   run_fed_avg, run_fleet_rounds, toy_task)
from repro_torch.fl.server import aggregate, apply_update, wire_bytes

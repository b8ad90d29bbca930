"""repro_torch.api — the public surface of the PyTorch port.

The subset of ``repro.api`` that the port provides so far::

    from repro_torch import api

    cfg = api.single_group(16, n_messages=1000)
    g = api.Group(cfg)                   # GPU; api.Group(cfg, device="cpu")
    g.subgroup(0).on_delivery(lambda member, msg: ...)
    report = g.run(backend="kernel")     # or "graph"

    # a parameter grid as ONE stacked round loop
    reports = g.run_batch(backend="kernel", windows=[5, 20, 100, 500])

Streaming (``Group.stream``), view changes and the DES backends follow in
later slices of the port.
"""

from repro_torch import resolve_device
from repro_torch.core.costmodel import HOST_X86, RDMA_CX6
from repro_torch.core.dds import (BoundDomain, Domain, QoS, Topic,
                                  many_topic_domain, single_topic_domain)
from repro_torch.core.group import (BACKENDS, Delivery, DeliveryLog,
                                    EpochCarry, GraphBackend, Group,
                                    GroupConfig, GroupStream, KernelBackend,
                                    ProtocolBackend, RunReport,
                                    SenderPattern, SpindleFlags, StreamView,
                                    SubgroupHandle, SubgroupSpec,
                                    get_backend, register_backend,
                                    single_group)
from repro_torch.load.admission import ServeAdmission
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.fanout import ReplicatedEngine

__all__ = [
    "BACKENDS", "BoundDomain", "Delivery", "DeliveryLog", "Domain",
    "EngineConfig", "EpochCarry", "GraphBackend", "Group", "GroupConfig",
    "GroupStream", "HOST_X86", "KernelBackend", "ProtocolBackend", "QoS",
    "RDMA_CX6", "ReplicatedEngine", "Request", "RunReport", "SenderPattern",
    "ServeAdmission", "ServeEngine", "SpindleFlags", "StreamView",
    "SubgroupHandle", "SubgroupSpec", "Topic", "get_backend",
    "many_topic_domain", "register_backend", "resolve_device",
    "single_group", "single_topic_domain",
]

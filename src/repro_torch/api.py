"""repro_torch.api — the public surface of the PyTorch port.

The subset of ``repro.api`` that the port provides so far::

    from repro_torch import api

    cfg = api.single_group(16, n_messages=1000)
    g = api.Group(cfg)                   # GPU; api.Group(cfg, device="cpu")
    g.subgroup(0).on_delivery(lambda member, msg: ...)
    report = g.run(backend="kernel")     # or "graph"

    # a parameter grid as ONE stacked round loop
    reports = g.run_batch(backend="kernel", windows=[5, 20, 100, 500])

    # the full-sequence forward of a model: every family (dense, moe,
    # ssm, hybrid, encdec, vlm)
    arch = api.get_arch("qwen3-1.7b")    # or "qwen2-moe-a2.7b", ...
    params = arch.init_params(seed=0, dtype=torch.bfloat16)  # device="cpu"
    loss = arch.loss_fn()(params, arch.cfg, {"tokens": tokens}, api.Runtime())
    logits, cache = arch.prefill_fn()(params, {"tokens": tokens},
                                      api.Runtime())
    step = api.make_serve_step(arch, api.Runtime(), "prefill")
    # the vlm's batch: {"patches", "tokens"}; the encdec's {"frames",
    # "tokens"} (its prefill is the encoder); shapes from
    # arch.input_specs(shape) (meta tensors)

    # serving any family: engines sharing one parameter set
    engines = [api.ServeEngine("qwen2-moe-a2.7b", params, arch.cfg,
                               api.EngineConfig(max_batch=8, max_len=2048))
               for _ in range(2)]
    rep = api.ReplicatedEngine(engines, window=8)
    report = rep.run()                   # or rep.run(fused=True)

    # the training plane: W data-parallel workers folded onto one device,
    # gradients reduced by fused buckets with an int8 all-gather leg
    rt = api.Runtime(gradsync="spindle_compressed", dp_workers=2)
    trainer = api.Trainer("qwen3-1.7b", arch.cfg,
                          api.TrainConfig(steps=3, seq_len=2048,
                                          global_batch=2), rt)
    params, opt_state = trainer.run()    # trainer.history: loss, grad_norm
    step = api.make_train_step(arch, rt, api.OptConfig())

    # a view change mid-stream: the virtual-synchrony cut
    ms = api.MembershipService(cfg.members)
    stream = g.stream(backend="kernel")
    stream.step(ready)                   # (G, S_max) counts this round
    ms.suspect(0, 3)
    view, stream = ms.reconfigure_stream(stream, {})   # next epoch

The DES backends follow in a later slice of the port.
"""

from repro_torch import resolve_device
from repro_torch.core import gradsync
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
from repro_torch.core.views import MembershipService, View
from repro_torch.load.admission import ServeAdmission
from repro_torch.models.registry import Arch
from repro_torch.models.registry import get as get_arch
from repro_torch.models.runtime import Runtime
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.optim.adamw import OptConfig
from repro_torch.serve.fanout import ReplicatedEngine
from repro_torch.train.steps import make_serve_step, make_train_step
from repro_torch.train.trainer import TrainConfig, Trainer

__all__ = [
    "Arch", "BACKENDS", "BoundDomain", "Delivery", "DeliveryLog", "Domain",
    "EngineConfig", "EpochCarry", "GraphBackend", "Group", "GroupConfig",
    "GroupStream", "HOST_X86", "KernelBackend", "MembershipService",
    "OptConfig", "ProtocolBackend", "QoS", "RDMA_CX6", "ReplicatedEngine",
    "Request", "RunReport", "Runtime", "SenderPattern",
    "ServeAdmission", "ServeEngine", "SpindleFlags", "StreamView",
    "SubgroupHandle", "SubgroupSpec", "Topic", "TrainConfig", "Trainer",
    "View", "get_arch", "get_backend", "gradsync",
    "make_serve_step", "make_train_step", "many_topic_domain",
    "register_backend", "resolve_device", "single_group",
    "single_topic_domain",
]

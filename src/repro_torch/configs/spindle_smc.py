"""The paper's own system configuration: Derecho SMC on the 16-node
100 Gbps testbed (Sec. 4), the defaults of the discrete-event simulator's
scenarios.  Not a model: the model registry does not hold it."""

import dataclasses

from repro_torch.core import costmodel, simulator


@dataclasses.dataclass(frozen=True)
class PaperSetup:
    n_nodes: int = 16
    msg_size: int = 10240
    window: int = 100
    net: costmodel.NetworkModel = costmodel.RDMA_CX6
    host: costmodel.HostModel = costmodel.HOST_X86

    def config(self, n_nodes=None, *, n_messages=1000, flags=None, **kw
               ) -> simulator.SimConfig:
        return simulator.single_subgroup(
            n_nodes if n_nodes is not None else self.n_nodes,
            msg_size=self.msg_size, window=self.window,
            n_messages=n_messages,
            flags=flags if flags is not None
            else simulator.SpindleFlags.spindle(),
            net=self.net, host=self.host, **kw)


PAPER = PaperSetup()

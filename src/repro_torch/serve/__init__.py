"""The serve plane of the port: the continuous-batching decode engine
(:mod:`repro_torch.serve.engine`) and its replicas' fan-out over the
streamed multicast (:mod:`repro_torch.serve.fanout`)."""

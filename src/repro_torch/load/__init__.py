"""The workload plane of the port.  So far only the serve plane's
admission policy (:class:`repro_torch.load.admission.ServeAdmission`);
arrival generators, admission policies and the load harness follow in a
later slice."""

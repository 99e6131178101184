"""Inter-stage links of the §4.3 pipeline: transports on a virtual clock,
deployment plans and the int8 activation codec (counterparts of
``repro.distributed.transport`` and ``repro.distributed.compression``)."""

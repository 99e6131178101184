"""Inter-stage links of the §4.3 pipeline (transports on a virtual clock,
deployment plans, the int8 activation codec), the gradient compressors of
data-parallel training, and fault tolerance (counterparts of
``repro.distributed.transport``, ``compression`` and ``elastic``)."""

"""The LM tenant's models (counterpart of ``repro/models``): the config
schema, the shared layers and their logical-axis rules, the Mamba2 SSD
mixer, the MoE FFN (dense and expert-parallel), the collectives of the
mesh paths (``comm``) and the unified decoder (``transformer``)."""

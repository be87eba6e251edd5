"""The LM tenant's models (counterpart of ``repro/models``): the config
schema, the shared layers, the Mamba2 SSD mixer, the dense MoE FFN and the
unified decoder (``transformer``)."""

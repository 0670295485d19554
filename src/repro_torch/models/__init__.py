"""The model substrate: configs' dataclasses (``common``), layers, the
Mamba-2 SSD block (``ssm``), the RG-LRU block (``rglru``), the MoE FFN
(``moe``) and the four families assembled into ``model.Model``, each
the counterpart of the reference module of the same name."""

"""Training: the train step (``step``), the fault-tolerant loop
(``loop``) and the GPipe schedule over a mesh axis (``pipeline``), each
the counterpart of the reference module of the same name."""

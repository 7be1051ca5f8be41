"""Multi-device paths of the port: process groups (``launch``) and the
("clip", "frame") mesh with the sharded complexity suite and quality step
(``sharding``), on ``torch.distributed``."""

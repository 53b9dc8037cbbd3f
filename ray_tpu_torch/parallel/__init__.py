"""The port's parallel training path: process groups
(``distributed.initialize``), the mesh over the canonical axes
(``mesh.create_mesh``), sharding rules (``sharding``), explicit
collectives (``collectives``), the train step on one device or a mesh
(``spmd.build_lm_train_step``), GPipe (``pipeline``), and a pool of rank
processes (``launch.RankPool``)."""

"""Sharding for the port's steps on a device mesh: the logical-axis hooks
the models call (:mod:`.context`), the partitioning rules
(:mod:`.sharding`) and the collectives the steps issue
(:mod:`.collectives`)."""

"""ASGD numeric core of the port: tree helpers, the Parzen gate, the ASGD
update, the pack-once layout and the packed-resident gossip engines; the
paper's K-Means workload (``kmeans``, eqs. 8-10, its E/M steps through
kernel B4), its baselines and round simulator (``baselines``), and the
threaded GASPI simulator (``async_sim``, a host simulator by design)."""

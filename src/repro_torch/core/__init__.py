"""ASGD numeric core of the port: tree helpers, the Parzen gate, the ASGD
update, the pack-once layout and the packed-resident gossip engines."""

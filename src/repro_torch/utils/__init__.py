"""The distributed layer's accounting: parameter sharding rules, the
collective trace of a dispatch, and the H100 roofline."""

"""CLI tools (↔ reference tools/): dhtnode interactive node/daemon,
dhtchat minimal IM, dhtscanner keyspace census, compat_check's live wire
exchanges, plus shared argv/identity helpers (↔ tools/tools_common.h).

The port's copies of the JAX package's tools, behaviour unchanged but
for the device: a tool's node runs on the CUDA card unless ``--cpu`` is
given, and without a card (and without ``--cpu``) it raises before any
socket is bound.  The JAX tools pin JAX to the CPU unless asked for the
accelerator; the port turns that around, as every entry point of the
port defaults to the card."""

"""The runtime's lock-order witness (``lock_witness``: ``make_lock`` and
``make_rlock``, which the raylet, GCS and worker import at boot).  The JAX
package's static analyzer beside it is a tool for that package's own
sources and is not ported."""

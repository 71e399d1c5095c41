"""The kernel pass's corpus, laid out as a package of the port (parsed,
never run): each ``kernels/<name>/ops.py`` here is read as a kernel
package's ``ops.py``, as the pass reads the real ones."""

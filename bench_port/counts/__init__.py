"""Operations and bytes of each hand-written kernel of the program, one
module a kernel, found by name.

A module names the program's entry points that launch the kernel
(``TARGETS``, "module:attribute" as the program's code calls it), the
substrings of its device kernels' names in a trace (``KERNEL_NAMES``),
``record(args, kwargs)``, which keeps a call's shapes and inputs and
launches nothing, and ``cost(record)``, which gives (operations, bytes)
once the traced request has ended. Bytes count each input read once and
each output written once; operations count what these inputs need."""

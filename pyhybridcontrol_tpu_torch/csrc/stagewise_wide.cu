// K5 at block sizes above 16 (bmax 32, 64 and 128: the runtime-r path
// with the wide row work), built from stagewise.cu as a library of its
// own so that nvcc compiles it beside the other parts (PHC_SW_PART there).
#define PHC_SW_PART 1
#include "stagewise.cu"

// K5's parallel sweep on the runtime-r path at bmax 8 and 16, built from
// stagewise.cu as a library of its own so that nvcc compiles it beside the
// other parts (PHC_SW_PART and PHC_SW_PAR there).
#define PHC_SW_PART 2
#define PHC_SW_PAR 1
#include "stagewise.cu"

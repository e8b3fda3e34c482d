// K5's horizon variant (a problem's horizon in windows over a cluster's
// CTAs), built from stagewise.cu as a library of its own so that nvcc
// compiles it beside the other parts (PHC_SW_PART there).
#define PHC_SW_PART 3
#include "stagewise.cu"
